"""The engine's elasticity helpers and legacy entry points, port vs JAX.

``snapshot``/``restore``/``resize`` (``repro/core/engine.py:443-492``) and
the deprecated ``engine.solve``/``solve_many`` shims
(``tests/test_session.py``'s three legacy tests), on the CPU:

* a mid-run state (``tests/test_engine.py::test_snapshot_restore_resize``'s:
  G(46, 0.25, 2), 8 workers, 3 supersteps of 4 explore rounds) made by both
  packages is equal leaf for leaf; a snapshot of either package restores in
  the other;
* ``resize`` of that state to fewer and to more workers equals the JAX
  package's slot for slot, and the resized solve reaches JAX's result and
  the sequential optimum;
* too small a capacity is refused by both.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_flat_equal

from repro.core import engine as JE
from repro.core import superstep as JS
from repro.graphs.bitgraph import n_words
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro.problems.base import make_data as jax_make_data
from repro.problems.registry import get_problem as jax_problem
from repro_torch.api.backends import LEGACY_CACHE
from repro_torch.core import engine as E
from repro_torch.core import superstep as S
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.problems.base import make_data
from repro_torch.problems.registry import get_problem
from repro_torch.problems.sequential import solve_sequential

CPU = dict(device="cpu")
GRAPH = (46, 0.25, 2)
P0, SPR, STEPS = 8, 4, 3


def _jax_mid_run():
    g = jax_erdos_renyi(*GRAPH)
    spec = jax_problem("vertex_cover")
    cap = 4 * g.n + 8
    state = jax.vmap(lambda _: JS.make_worker_state(cap, n_words(g.n), g.n + 1))(
        jnp.arange(P0))
    state = JE._scatter_startup(state, spec, g, P0)
    fn = JS.build_superstep_fn(spec, jax_make_data(spec, g), num_workers=P0,
                               steps_per_round=SPR, lanes=1)
    for _ in range(STEPS):
        state, _ = fn(state)
    return state


def _port_mid_run():
    g = erdos_renyi(*GRAPH)
    spec = get_problem("vertex_cover")
    state = E.make_instance_state(spec, g, P0, 4 * g.n + 8, g.W, g.n + 1, "cpu")
    data = make_data(spec, g, "cpu")
    for _ in range(STEPS):
        state, _ = S.superstep(spec, data, state, steps_per_round=SPR, lanes=1)
    return state


def _jax_flat(snap: dict) -> dict:
    """A JAX snapshot in the port's flat naming, for ``assert_flat_equal``."""
    flat = {f"worker.frontier.{k}": np.asarray(v)
            for k, v in snap["frontier"]._asdict().items()}
    flat.update({f"worker.{k}": np.asarray(v) for k, v in snap.items() if k != "frontier"})
    return flat


def test_mid_run_states_and_snapshots_equal():
    jsnap = JE.snapshot(_jax_mid_run())
    psnap = E.snapshot(_port_mid_run())
    assert sorted(psnap) == sorted(jsnap)
    assert psnap["frontier"]._fields == jsnap["frontier"]._fields
    assert_flat_equal(_jax_flat(jsnap), _jax_flat(psnap))
    assert psnap["frontier"].masks.dtype == np.uint32


def test_snapshots_restore_across_packages():
    """JAX snapshot -> port restore -> port snapshot is the JAX snapshot, and
    port snapshot -> JAX restore -> JAX snapshot is the port's; a plain dict
    frontier restores too."""
    jsnap = JE.snapshot(_jax_mid_run())
    back = E.snapshot(E.restore(jsnap, **CPU))
    assert_flat_equal(_jax_flat(jsnap), _jax_flat(back))
    psnap = E.snapshot(_port_mid_run())
    there = JE.snapshot(JE.restore(psnap))
    assert_flat_equal(_jax_flat(psnap), _jax_flat(there))
    as_dict = dict(psnap, frontier=psnap["frontier"]._asdict())
    assert_flat_equal(_jax_flat(psnap), _jax_flat(E.snapshot(E.restore(as_dict, **CPU))))


@pytest.mark.parametrize("new_workers", [5, 13])
def test_resize_equals_jax_slot_for_slot(new_workers):
    jsnap = JE.snapshot(_jax_mid_run())
    want = JE.snapshot(JE.resize(JE.restore(jsnap), new_workers))
    got = E.resize(E.restore(jsnap, **CPU), new_workers)
    assert got.best_val.shape == (new_workers,)
    assert_flat_equal(_jax_flat(want), _jax_flat(E.snapshot(got)))
    # every pending task survives, once
    pending = int(np.asarray(jsnap["frontier"].active).sum())
    assert int(got.frontier.active.sum()) == pending > new_workers


def test_resized_solve_reaches_jax_result():
    """``test_snapshot_restore_resize``: restart on 5 workers from the
    resized mid-run state; the port's legacy solve equals JAX's."""
    g, jg = erdos_renyi(*GRAPH), jax_erdos_renyi(*GRAPH)
    want_opt, _, _ = solve_sequential(g)
    resized = E.resize(E.restore(E.snapshot(_port_mid_run()), **CPU), 5)
    jresized = JE.resize(JE.restore(JE.snapshot(_jax_mid_run())), 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = E.solve(g, num_workers=5, steps_per_round=8, initial_state=resized, **CPU)
        jr = JE.solve(jg, num_workers=5, steps_per_round=8, initial_state=jresized)
    assert r.best_size == jr.best_size == want_opt
    assert (r.best_sol == np.asarray(jr.best_sol)).all()
    for f in ("rounds", "nodes_expanded", "tasks_transferred", "overflow_count",
              "transfer_rounds", "transfer_bytes_total"):
        assert getattr(r, f) == getattr(jr, f), f


def test_resize_refuses_too_small_a_capacity():
    state = _port_mid_run()
    cap = state.frontier.capacity
    small = S.map_state(lambda x: x.clone(), state)
    small.frontier.active[:, : cap // 2] = True  # 8 * cap/2 tasks on 1 worker
    with pytest.raises(ValueError, match="capacity"):
        E.resize(small, 1)
    with pytest.raises(AssertionError, match="capacity"):
        JE.resize(JE.restore(E.snapshot(small)), 1)


# -- the legacy shims (tests/test_session.py section 6, on the port) ----------


def test_legacy_solve_warns_and_accepts_compact_threshold():
    g = erdos_renyi(18, 0.3, 0)
    with pytest.warns(DeprecationWarning, match="SolverSession"):
        r = E.solve(g, num_workers=4, steps_per_round=8, compact_threshold=0.5, **CPU)
    assert r.best_size == solve_sequential(g)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jr = JE.solve(jax_erdos_renyi(18, 0.3, 0), num_workers=4, steps_per_round=8)
    assert (r.best_size, r.rounds, r.nodes_expanded) == (jr.best_size, jr.rounds,
                                                         jr.nodes_expanded)
    # a real mesh is the multi-device path, not ported yet
    with pytest.warns(DeprecationWarning), pytest.raises(NotImplementedError,
                                                         match="item 13"):
        E.solve(g, num_workers=4, mesh=object(), **CPU)


def test_legacy_solve_many_warns_and_accepts_mesh_none():
    gs = [erdos_renyi(18, 0.3, s) for s in range(2)]
    with pytest.warns(DeprecationWarning, match="SolverSession"):
        batch = E.solve_many(gs, num_workers=4, steps_per_round=8, mesh=None, **CPU)
    assert [r.best_size for r in batch.results] == [solve_sequential(g)[0] for g in gs]
    # a real mesh on the batched plane is refused, as in the JAX package
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="mesh"):
        E.solve_many(gs, num_workers=4, mesh=object(), **CPU)


def test_legacy_shims_share_one_plane_cache():
    g1, g2 = erdos_renyi(21, 0.3, 0), erdos_renyi(21, 0.3, 1)
    with pytest.warns(DeprecationWarning):
        E.solve(g1, num_workers=4, steps_per_round=8, **CPU)
        hits0 = LEGACY_CACHE.stats().hits
        E.solve(g2, num_workers=4, steps_per_round=8, **CPU)
    assert LEGACY_CACHE.stats().hits == hits0 + 1


def test_legacy_shims_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError, match="CUDA"):
        E.solve(erdos_renyi(12, 0.3, 0), num_workers=2)
