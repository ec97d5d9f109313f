"""Whole solves that overflow their frontier, the port against the JAX
package on the CPU, field for field, ``overflow_count`` included.

A starved ``capacity`` drops tasks at ``push_many``; the dropped search
changes the trajectory, so these cases pin the chunk loop, the frontier's
saturation and the batched plane's compaction together: solo vertex cover
(with ``lanes=2``, and with ``donate_k=2`` under the random policy), solo
max clique, ``solve_many`` of vertex cover, batched MIS with a compaction,
``solve_many`` with a per-instance fpt ``k``, and an overflowing stream
through both services.
"""

import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolveService as JaxService
from repro.api import SolverSession as JaxSession
from repro.graphs.generators import erdos_renyi
from repro_torch.api import SolveConfig, SolveService, SolverSession

FIELDS = ("best_size", "found", "rounds", "nodes_expanded", "tasks_transferred")
STATS = ("overflow", "overflow_count", "control_bytes_per_round",
         "transfer_rounds", "transfer_bytes_total", "transfer_bytes_per_round")


def _same(want, got):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    if want.best_sol is None:
        assert got.best_sol is None
    else:
        assert (np.asarray(got.best_sol) == np.asarray(want.best_sol)).all()
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name


def _sessions(problem, **kw):
    return (JaxSession(problem=problem, config=JaxConfig(**kw)),
            SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu"))


SOLO = {
    "vc_cap3": ("vertex_cover", (26, 0.3, 0), dict(num_workers=4, steps_per_round=4,
                                                   capacity=3)),
    "vc_cap4_lanes2": ("vertex_cover", (30, 0.3, 1), dict(num_workers=4, steps_per_round=4,
                                                          capacity=4, lanes=2)),
    "vc_cap4_donate2_random": ("vertex_cover", (28, 0.3, 2), dict(
        num_workers=4, steps_per_round=4, capacity=4, donate_k=2, policy="random")),
    "max_clique_cap4": ("max_clique", (30, 0.5, 3), dict(num_workers=4, steps_per_round=4,
                                                         capacity=4)),
}


@pytest.mark.parametrize("label", sorted(SOLO))
def test_solo_overflow_matches_jax(label):
    problem, (n, p, seed), kw = SOLO[label]
    js, ts = _sessions(problem, **kw)
    want = js.solve(erdos_renyi(n, p, seed))
    assert want.stats.overflow_count > 0  # the config really starves
    _same(want, ts.solve(erdos_renyi(n, p, seed)))


def test_solve_many_vc_overflow_matches_jax():
    gs = [erdos_renyi(n, 0.3, 10 + i) for i, n in enumerate((18, 26, 22, 30, 20, 24))]
    js, ts = _sessions("vertex_cover", num_workers=4, steps_per_round=4, capacity=4)
    want, got = js.solve_many(gs), ts.solve_many(gs)
    assert sum(r.stats.overflow_count for r in want.results) > 0
    for w, g in zip(want.results, got.results):
        _same(w, g)


def test_batched_mis_overflow_with_compaction_matches_jax():
    gs = [erdos_renyi(n, 0.5, 20 + i) for i, n in enumerate((14, 24, 16, 30))]
    js, ts = _sessions("mis", num_workers=2, steps_per_round=2, capacity=5,
                       chunk_rounds=3)
    want, got = js.solve_many(gs), ts.solve_many(gs)
    assert want.compactions == got.compactions == 1
    assert sum(r.stats.overflow_count for r in want.results) > 0
    for w, g in zip(want.results, got.results):
        _same(w, g)
    for name in ("chunk_calls", "lane_chunks", "live_lane_chunks", "occupancy"):
        assert getattr(got.lane_stats, name) == getattr(want.lane_stats, name), name


def test_solve_many_per_instance_fpt_k_matches_jax():
    gs = [erdos_renyi(n, 0.3, 30 + i) for i, n in enumerate((18, 22, 26, 20))]
    js, ts = _sessions("vertex_cover", num_workers=4, steps_per_round=4, capacity=6,
                       mode="fpt", k=(12, 12, 14, 10))
    want, got = js.solve_many(gs), ts.solve_many(gs)
    assert {r.found for r in want.results} == {True, False}
    for w, g in zip(want.results, got.results):
        _same(w, g)


def test_overflowing_stream_through_the_service_matches_jax():
    kw = dict(num_workers=2, steps_per_round=4, capacity=6, service_lanes=2,
              chunk_rounds=2)
    gs = [erdos_renyi(n, 0.3, i) for i, n in enumerate((26, 18, 30, 22, 28))]
    jsvc = JaxService("vertex_cover", JaxConfig(**kw))
    tsvc = SolveService("vertex_cover", SolveConfig(**kw), device="cpu")
    tickets = [(jsvc.submit(g), tsvc.submit(g)) for g in gs]
    assert jsvc.drain() == tsvc.drain()
    dropped = 0
    for tj, tt in tickets:
        want = jsvc.result(tj)
        _same(want, tsvc.result(tt))
        dropped += want.stats.overflow_count
    assert dropped > 0
