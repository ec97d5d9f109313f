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


# -- the superstep owns what it writes --------------------------------------------
# Every push inside a superstep writes the frontier in place, into the copy the
# superstep takes on entry: its input is never written, so the chunk runner's
# freeze, snapshots and the state read between supersteps stay valid.


def _leaves(state):
    return [*state.frontier, *state[1:]]


def _unchanged(before, state):
    return all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))


def _lane_state(graphs, P, W):
    """A (B, P, ...) startup-scattered lane state of ``graphs`` on the CPU."""
    from repro_torch.core import engine as torch_engine

    spec = get_torch_problem("vertex_cover")
    cap = 4 * max(g.n for g in graphs) + 8
    bests = [g.n + 1 for g in graphs]
    return torch_engine._make_batch_state(spec, graphs, P, cap, W, bests, "cpu")


@pytest.mark.parametrize("explore_impl", ["fused", "reference"])
def test_superstep_never_writes_its_input(explore_impl):
    g = erdos_renyi(N, 0.2, 7)
    spec = get_torch_problem("vertex_cover")
    state = tss.worker_state_from_flat(_random_state_flat(11), "cpu")
    before = [x.clone() for x in _leaves(state)]
    new, _ = tss.superstep(
        spec, torch_make_data(spec, g, "cpu"), state, steps_per_round=2, lanes=2,
        donate_k=3, explore_impl=explore_impl,
    )
    assert _unchanged(before, state)
    assert int(new.nodes_expanded.sum()) > 0 and int(new.tasks_sent.sum()) > 0
    assert not torch.equal(new.frontier.masks, state.frontier.masks)


def test_batch_plane_never_writes_its_input():
    from repro_torch.problems import base as tb

    graphs = [erdos_renyi(n, 0.3, 40 + n) for n in (22, 28)]
    spec = get_torch_problem("vertex_cover")
    worker = _lane_state(graphs, 4, W)
    done = torch.zeros((2,), dtype=torch.bool)
    before = [x.clone() for x in _leaves(worker)]
    plane = tss.build_batch_plane_fn(spec, steps_per_round=2, lanes=2, chunk_rounds=3)
    new, _, _, ran, _ = plane(tb.make_batch_data(spec, graphs, 28, W, "cpu"), worker, done)
    assert ran == 3 and _unchanged(before, worker)
    assert not torch.equal(new.frontier.masks, worker.frontier.masks)


@pytest.mark.parametrize("fpt", [False, True], ids=["quiescent", "fpt"])
def test_frozen_lane_keeps_the_state_it_finished_with(fpt):
    """Lane 0 (a small graph) finishes partway through a chunk in which lane 1
    keeps stepping: after the chunk, lane 0's leaves are its state at the
    superstep it finished, as one-superstep chunks give it.  Under FPT lane 0
    finishes at its second cover, with tasks still pending in its pools."""
    from repro_torch.problems import base as tb

    graphs = [erdos_renyi(20, 0.3, 3), erdos_renyi(30, 0.3, 4)]
    spec = get_torch_problem("vertex_cover")
    datas = tb.make_batch_data(spec, graphs, 30, W, "cpu")
    knobs = dict(steps_per_round=1, lanes=1, use_fpt=fpt)
    bounds = torch.tensor([13, -1], dtype=torch.int32) if fpt else None
    start = _lane_state(graphs, 4, W)

    one = tss.build_batch_plane_fn(spec, chunk_rounds=1, **knobs)
    worker, done, finished_at = start, torch.zeros((2,), dtype=torch.bool), 0
    while not bool(done[0]):
        worker, done, _, _, _ = one(datas, worker, done, bounds)
        finished_at += 1
    at_finish = [x[0].clone() for x in _leaves(worker)]
    assert not bool(done[1]) and finished_at > 1
    assert bool(worker.frontier.active[0].any()) == fpt

    chunk = tss.build_batch_plane_fn(spec, chunk_rounds=finished_at + 3, **knobs)
    worker, done, delta, ran, _ = chunk(
        datas, start, torch.zeros((2,), dtype=torch.bool), bounds
    )
    assert ran > finished_at and delta.tolist()[0] == finished_at
    assert all(torch.equal(a, b[0]) for a, b in zip(at_finish, _leaves(worker)))
