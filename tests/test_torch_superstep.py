"""The superstep: the port's batched form against the JAX superstep vmapped
over workers.

* ``match_idle_to_donors`` under both policies on random status vectors
  (``jnp.argsort`` is stable; the port passes ``stable=True``; the
  ``mode="drop"`` scatters are masked explicitly);
* one superstep from one state — the JAX state goes through the flat
  checkpoint layout into the port — for sparse and gather transfers,
  packed and unpacked status, ``donate_k`` 1 and 3, ``lanes`` 1 and 2 and
  a codec pad; the whole flat state must be equal afterwards;
* ties among terminal lanes: the best cover is the first lane's, as
  ``jnp.argmin`` picks (``superstep.py:189``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_flat_equal, random_masks

from repro.core import superstep as jss
from repro.graphs.generators import erdos_renyi
from repro.problems.base import make_data as jax_make_data
from repro.problems.registry import get_problem
from repro_torch.core import superstep as tss
from repro_torch.problems.base import make_data as torch_make_data
from repro_torch.problems.registry import get_problem as get_torch_problem

N, P, CAP = 32, 6, 24
W = 1


@pytest.mark.parametrize("priority", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_match_idle_to_donors(priority, seed):
    rng = np.random.default_rng(seed)
    Pm = int(rng.integers(1, 40))
    pending = rng.integers(0, 4, size=Pm).astype(np.int32)
    depth = rng.integers(0, 6, size=Pm).astype(np.int32)  # many ties
    depth[pending == 0] = 1 << 30
    rounds = np.int32(rng.integers(0, 1000))
    want = jss.match_idle_to_donors(
        jnp.asarray(pending), jnp.asarray(depth), priority, jnp.int32(rounds)
    )
    got = tss.match_idle_to_donors(
        torch.from_numpy(pending), torch.from_numpy(depth), priority,
        torch.tensor(rounds, dtype=torch.int32),
    )
    for a, b in zip(want, got):
        assert (b.numpy() == np.asarray(a)).all()


def _random_state_flat(seed: int) -> dict:
    """A (P, ...) JAX worker state, flat, with random plausible pools: some
    workers idle, some deep, so the center matches and the data plane runs."""
    rng = np.random.default_rng(seed)
    state = jax.vmap(lambda _: jss.make_worker_state(CAP, W, N + 1))(jnp.arange(P))
    masks = random_masks(rng, N, W, P * CAP).reshape(P, CAP, W)
    sols = random_masks(rng, N, W, P * CAP).reshape(P, CAP, W) & ~masks
    active = rng.random((P, CAP)) < rng.random((P, 1))
    active[:2] = False  # two idle workers
    state = state._replace(
        frontier=state.frontier._replace(
            masks=jnp.asarray(masks),
            sols=jnp.asarray(sols),
            depths=jnp.asarray(rng.integers(0, 20, size=(P, CAP)).astype(np.int32)),
            active=jnp.asarray(active),
        ),
        rounds=jnp.full((P,), 5, jnp.int32),  # the round-robin salt
    )
    return jss.worker_state_to_flat(state)


CONFIGS = [
    dict(transfer_impl="sparse", packed_status=True, donate_k=1, lanes=1),
    dict(transfer_impl="gather", packed_status=True, donate_k=3, lanes=2,
         transfer_pad_words=N * W),
    dict(transfer_impl="sparse", packed_status=False, donate_k=3, lanes=1,
         policy_priority=False),
    dict(transfer_impl="gather", packed_status=False, donate_k=1, lanes=2,
         skip_empty_transfer=False),
    dict(transfer_impl="sparse", packed_status=True, donate_k=3, lanes=2,
         policy_priority=False, skip_empty_transfer=False),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_one_superstep_from_one_state(cfg):
    g = erdos_renyi(N, 0.2, 7)
    flat = _random_state_flat(11)
    jax_step = jss.build_superstep_fn(
        get_problem("vertex_cover"), jax_make_data(get_problem("vertex_cover"), g),
        num_workers=P, steps_per_round=2, explore_impl="fused", **cfg,
    )
    jax_state, jax_done = jax_step(jss.worker_state_from_flat(flat))

    spec = get_torch_problem("vertex_cover")
    torch_state, torch_done = tss.superstep(
        spec, torch_make_data(spec, g, "cpu"),
        tss.worker_state_from_flat(flat, "cpu"), steps_per_round=2, **cfg,
    )
    assert bool(torch_done) == bool(jax_done)
    assert_flat_equal(jss.worker_state_to_flat(jax_state), tss.worker_state_to_flat(torch_state))
    # the state really moved: tasks were explored, and some were transferred
    assert int(torch_state.nodes_expanded.sum()) > 0
    assert int(torch_state.tasks_sent.sum()) > 0


def test_flat_round_trip():
    flat = _random_state_flat(3)
    assert_flat_equal(flat, tss.worker_state_to_flat(tss.worker_state_from_flat(flat, "cpu")))


def test_terminal_ties_take_the_first_lane():
    """Two lanes of a worker reach terminals of the same size with different
    covers: the best solution is the first lane's, as ``jnp.argmin`` picks
    (``superstep.py:189``).  On an edgeless graph every task is terminal."""
    from repro.graphs.bitgraph import BitGraph

    g = BitGraph.from_edges(N, [])
    rng = np.random.default_rng(5)
    state = jax.vmap(lambda _: jss.make_worker_state(CAP, W, N + 1))(jnp.arange(P))
    depths = np.zeros((P, CAP), np.int32)
    depths[:, :2] = 7  # slots 0 and 1 pop first, in slot order
    sols = np.zeros((P, CAP, W), np.uint32)
    sols[:, 0, 0], sols[:, 1, 0] = 0b0011, 0b1100  # equal size, different covers
    masks = random_masks(rng, N, W, P * CAP).reshape(P, CAP, W) & ~sols
    state = state._replace(frontier=state.frontier._replace(
        masks=jnp.asarray(masks), sols=jnp.asarray(sols),
        depths=jnp.asarray(depths), active=jnp.ones((P, CAP), bool),
    ))
    jvc_spec = get_problem("vertex_cover")
    jdata = jax_make_data(jvc_spec, g)
    want = jax.vmap(lambda s: jss._explore_one_round(jvc_spec, jdata, s, 2, "fused"))(state)
    spec = get_torch_problem("vertex_cover")
    got = tss._explore_one_round(
        spec, torch_make_data(spec, g, "cpu"),
        tss.worker_state_from_flat(jss.worker_state_to_flat(state), "cpu"), 2,
    )
    assert_flat_equal(jss.worker_state_to_flat(want), tss.worker_state_to_flat(got))
    assert (tss.worker_state_to_flat(got)["worker.best_sol"][:, 0] == 0b0011).all()
