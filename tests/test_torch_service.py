"""The port's live ``SolveService`` on the CPU: ``tests/test_service.py``
mirrored on ``repro_torch``, the goldens through a 2-lane service, and a
step-by-step parity run against the JAX package's service.

* every solo and fpt golden of ``tests/golden_vc.json`` reproduces in a lane
  next to a live lanemate;
* instances churning through reused lanes equal their solo solves;
* admission into freed lanes builds no new plane (the port's analogue of
  the JAX package's ``PLANE_TRACES``: ``cache_stats()["planes"]``);
* streaming, ``result()`` before completion, overflow, superstep and
  wall-clock deadlines, validation, deterministic scheduling, tenant caps
  and per-request fpt ``k``, as in the JAX tests;
* one seeded stream (mixed sizes over two W buckets, priorities, superstep
  deadlines, ``deadline_s`` on a shared injected clock, tenants under
  ``tenant_max_lanes``, fpt with per-request ``k``) through JAX's service and
  the port's, on vertex cover and max clique: the same tickets complete at
  the same step in the same order, with equal result fields and equal
  ``ServiceStats`` and ``stats()``;
* the JAX test ``test_wall_deadline_survives_checkpoint_restore``: a
  request's ``deadline_s`` rides through ``checkpoint()``/``restore()``
  (the rest of the service's durability is ``tests/test_torch_durability.py``);
* the JAX service's fault injection is refused with its ROADMAP item
  (spill is held against the JAX service in ``tests/test_torch_spill.py``).
"""

import json
import pathlib

import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolveService as JaxService
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import (
    PlaneCache,
    SolveConfig,
    SolveService,
    SolverSession,
    solve_stream_session,
)
from repro_torch.api.backends import config_from_legacy
from repro_torch.api.service import LaneScheduler, SolveRequest
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.problems.sequential import (
    solve_sequential,
    solve_sequential_max_clique,
)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden_vc.json").read_text()
)
CPU = dict(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _record(r) -> dict:
    return {
        "best_size": int(r.best_size),
        "best_sol": (None if r.best_sol is None
                     else [int(w) for w in np.asarray(r.best_sol, np.uint32)]),
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
    }


# -- 1. bit-identity: the live plane vs the solo goldens -----------------------


@pytest.mark.parametrize("label", sorted(GOLDEN["solo"]))
def test_service_result_bit_identical_to_solo_golden(label):
    case = GOLDEN["solo"][label]
    gkw = case["graph"]
    g = erdos_renyi(gkw["n"], gkw["p"], gkw["seed"])
    cfg = config_from_legacy(**case["solve_kw"]).replace(service_lanes=2)
    svc = SolveService("vertex_cover", cfg, **CPU)
    g_mate = erdos_renyi(gkw["n"], gkw["p"], gkw["seed"] + 77)
    ticket = svc.submit(g)
    lanemate = svc.submit(g_mate)
    svc.drain()
    r = svc.result(ticket)
    assert (r.problem, r.backend, r.found) == ("vertex_cover", "spmd", True)
    assert _record(r) == case["result"]
    assert svc.result(lanemate).best_size == solve_sequential(g_mate)[0]
    assert svc.idle() and not svc.ready(ticket)  # result() pops


def test_service_fpt_bit_identical_to_golden():
    case = GOLDEN["fpt"]
    gkw = case["graph"]
    g = erdos_renyi(gkw["n"], gkw["p"], gkw["seed"])
    cfg = SolveConfig(num_workers=4, mode="fpt", k=case["k"], service_lanes=2)
    svc = SolveService("vertex_cover", cfg, **CPU)
    t = svc.submit(g)  # k defaults from the config in fpt mode
    svc.drain()
    r = svc.result(t)
    assert _record(r) == case["result"]
    # the service envelope rides in the result's JSON view
    d = json.loads(json.dumps(r.to_dict()))
    assert d["stats"]["service"]["plane"] == "(1, None)"
    assert d["stats"]["service"]["deadline_hit"] is False
    assert SolverSession(config=cfg, **CPU).solve(g).stats.service is None


def test_service_churn_matches_solo_across_sizes():
    cfg = SolveConfig(num_workers=4, steps_per_round=8, service_lanes=2)
    sizes = [18, 26, 22, 30, 20, 24]
    gs = [erdos_renyi(n, 0.3, 200 + i) for i, n in enumerate(sizes)]
    svc = SolveService("vertex_cover", cfg, **CPU)
    tickets = [svc.submit(g) for g in gs]
    svc.drain()
    sess = SolverSession(problem="vertex_cover", config=cfg, **CPU)
    for t, g in zip(tickets, gs):
        r, solo = svc.result(t), sess.solve(g)
        assert _record(r) == _record(solo)
        assert r.stats.overflow_count == solo.stats.overflow_count


# -- 2. admission into freed lanes builds nothing ------------------------------


def test_admission_into_freed_lanes_builds_no_plane():
    cfg = SolveConfig(num_workers=4, steps_per_round=8, service_lanes=2)
    svc = SolveService("vertex_cover", cfg, **CPU)
    wave1 = [svc.submit(erdos_renyi(20, 0.3, s)) for s in range(2)]
    svc.drain()
    planes0 = svc.cache_stats()["planes"]
    lanes0 = svc._planes[(1, None)].lanes
    wave2 = [svc.submit(erdos_renyi(24, 0.3, 10 + s)) for s in range(4)]
    svc.drain()
    assert svc.cache_stats()["planes"] == planes0 == 1
    # the plane's lane tensors keep their shapes: no compaction, no resize
    lanes1 = svc._planes[(1, None)].lanes
    assert lanes1.worker.frontier.masks.shape == lanes0.worker.frontier.masks.shape
    for t in wave1 + wave2:
        assert svc.ready(t)
    stats = svc.stats()
    assert stats["completed"] == 6 and stats["planes"] == 1
    assert 0.0 < stats["occupancy"] <= 1.0
    assert stats["reduce_sweeps"] > 0


class _CountingCache(PlaneCache):
    """Sums the superstep count (``ran``) of every batched-plane chunk."""

    ran = 0

    def batch_plane(self, *a):
        plane = super().batch_plane(*a)

        def counted(*args, **kw):
            out = plane(*args, **kw)
            self.ran += out[3]
            return out

        return counted


@pytest.mark.parametrize("lanes", [2, 6])
def test_supersteps_count_every_chunk(lanes):
    """``stats()["supersteps"]`` is the sum of the chunks' superstep counts:
    the longest ticket's rounds when every ticket is admitted at once, and
    at most the tickets' sum when freed lanes re-admit."""
    cfg = SolveConfig(num_workers=4, steps_per_round=4, chunk_rounds=3,
                      service_lanes=lanes)
    cache = _CountingCache()
    svc = SolveService("vertex_cover", cfg, cache=cache, **CPU)
    tickets = [svc.submit(erdos_renyi(n, 0.3, 300 + n)) for n in (16, 22, 28, 20, 25, 18)]
    svc.drain()
    rounds = [svc.result(t).rounds for t in tickets]
    ran = svc.stats()["supersteps"]
    assert ran == cache.ran and ran >= max(rounds)
    if lanes >= len(tickets):
        assert ran == max(rounds)
    else:
        assert ran <= sum(rounds)


def test_vacant_and_retired_lanes_stay_inert():
    """A 4-lane plane with one occupant runs many chunks next to vacant
    lanes and, later, a retired lane whose stale frontier is not empty: the
    occupant equals its solo solve and the other lanes' state never moves."""
    cfg = SolveConfig(num_workers=2, steps_per_round=2, chunk_rounds=1,
                      service_lanes=4, admission="fifo")
    svc = SolveService("vertex_cover", cfg, **CPU)
    evicted = svc.submit(erdos_renyi(30, 0.5, 3), deadline=1)
    g = erdos_renyi(30, 0.5, 4)
    t = svc.submit(g)
    svc.step()  # the first ticket is evicted with pending tasks on its lane
    assert svc.ready(evicted)
    plane = svc._planes[(1, None)]
    lane = svc.result(evicted).stats.service.lane
    stale = plane.lanes.worker.frontier.active[lane].clone()
    assert bool(stale.any())
    vacant = [i for i in range(4) if plane.requests[i] is None and i != lane]
    blank = plane.lanes.worker.best_val[vacant].clone()
    steps = 0
    while not svc.ready(t):
        svc.step()
        steps += 1
    assert steps > 3
    assert bool((plane.lanes.worker.frontier.active[lane] == stale).all())
    assert bool((plane.lanes.worker.best_val[vacant] == blank).all())
    assert bool((blank == 0).all())  # a vacant lane's worker has best 0
    solo = SolverSession(problem="vertex_cover", config=cfg, **CPU).solve(g)
    assert _record(svc.result(t)) == _record(solo)


# -- 3. streaming lifecycle ----------------------------------------------------


def test_out_of_order_completion_streams_early_finishers():
    cfg = SolveConfig(
        num_workers=2, steps_per_round=2, chunk_rounds=1, service_lanes=2,
        admission="fifo",
    )
    svc = SolveService("vertex_cover", cfg, **CPU)
    hard = svc.submit(erdos_renyi(30, 0.5, 3))
    easy = svc.submit(erdos_renyi(8, 0.3, 4))
    completed, steps = [], 0
    while not svc.ready(easy):
        completed.extend(svc.step())
        steps += 1
        assert steps < 200
    assert completed[0] == easy
    if not svc.ready(hard):
        assert svc.status()["planes"]["(1, None)"]["tickets"] == [hard]
    assert svc.result(easy).best_size == solve_sequential(erdos_renyi(8, 0.3, 4))[0]
    svc.drain()
    assert svc.result(hard).best_size == solve_sequential(erdos_renyi(30, 0.5, 3))[0]


def test_result_before_completion_raises_keyerror():
    svc = SolveService("vertex_cover", SolveConfig(num_workers=2, service_lanes=2), **CPU)
    t = svc.submit(erdos_renyi(12, 0.3, 0))
    assert not svc.ready(t)
    with pytest.raises(KeyError):
        svc.result(t)
    with pytest.raises(KeyError):
        svc.result(999)
    svc.drain()
    assert svc.ready(t) and svc.result(t).found


def test_overflow_count_propagates_into_streamed_results():
    cfg = SolveConfig(num_workers=2, steps_per_round=4, capacity=6, service_lanes=2)
    g = erdos_renyi(26, 0.3, 0)
    solo = SolverSession(problem="vertex_cover", config=cfg, **CPU).solve(g)
    assert solo.stats.overflow_count > 0  # the config really starves
    svc = SolveService("vertex_cover", cfg, **CPU)
    t = svc.submit(g)
    svc.drain()
    r = svc.result(t)
    assert r.stats.overflow_count == solo.stats.overflow_count
    assert r.stats.overflow and r.best_size == solo.best_size


def test_deadline_evicts_with_anytime_result():
    cfg = SolveConfig(num_workers=2, steps_per_round=2, chunk_rounds=1, service_lanes=2)
    g = erdos_renyi(32, 0.5, 7)
    svc = SolveService("vertex_cover", cfg, **CPU)
    t = svc.submit(g, deadline=1)
    svc.drain()
    r = svc.result(t)
    assert r.stats.service.deadline_hit is True
    assert r.rounds == 1
    assert svc.stats()["evicted"] == 1
    full = SolverSession(problem="vertex_cover", config=cfg, **CPU).solve(g)
    assert r.best_size >= full.best_size
    # the evicted lane equals a solo solve capped at the same budget
    capped = SolverSession(problem="vertex_cover", config=cfg.replace(max_rounds=1),
                           **CPU).solve(g)
    assert _record(r) == _record(capped)
    svc2 = SolveService("vertex_cover", cfg, **CPU)
    t2 = svc2.submit(erdos_renyi(12, 0.3, 1), deadline=500)
    svc2.drain()
    assert svc2.result(t2).stats.service.deadline_hit is False


def test_wall_deadline_evicts_on_injected_clock():
    clk = FakeClock()
    cfg = SolveConfig(num_workers=4, steps_per_round=2, chunk_rounds=2, service_lanes=2)
    svc = SolveService("vertex_cover", cfg, clock=clk, **CPU)
    g = erdos_renyi(40, 0.28, 0)
    t = svc.submit(g, deadline_s=5.0)
    svc.step()
    assert not svc.ready(t)
    clk.t = 10.0
    assert svc.step() == [t]
    r = svc.result(t)
    assert r.stats.service.wall_deadline_hit is True
    assert r.stats.service.deadline_hit is False
    assert r.found
    full = SolverSession(problem="vertex_cover", config=cfg, **CPU).solve(g)
    assert r.best_size >= full.best_size
    assert svc.stats()["evicted"] == 1
    svc2 = SolveService("vertex_cover", cfg, clock=FakeClock(), **CPU)
    t2 = svc2.submit(erdos_renyi(12, 0.3, 1), deadline_s=100.0)
    svc2.drain()
    s2 = svc2.result(t2).stats.service
    assert s2.wall_deadline_hit is False and s2.deadline_hit is False


def test_submit_validation():
    svc = SolveService("vertex_cover", SolveConfig(num_workers=2, service_lanes=2), **CPU)
    with pytest.raises(ValueError, match="fpt"):
        svc.submit(erdos_renyi(10, 0.3, 0), k=3)
    with pytest.raises(ValueError, match="deadline"):
        svc.submit(erdos_renyi(10, 0.3, 0), deadline=0)
    with pytest.raises(ValueError, match="servable"):
        SolveService("vertex_cover", SolveConfig(num_workers=2, use_mesh=True), **CPU)


def test_wall_deadline_survives_checkpoint_restore(tmp_path):
    """``deadline_s`` rides the request metadata through checkpoint(): a
    restored service still enforces the original wall budget."""
    cfg = SolveConfig(
        num_workers=4, steps_per_round=2, chunk_rounds=1, service_lanes=2
    )
    svc = SolveService("vertex_cover", cfg, clock=FakeClock(), **CPU)
    svc.submit(erdos_renyi(40, 0.28, 0), deadline_s=5.0)
    svc.step()
    svc.checkpoint(str(tmp_path / "ck"))
    back = SolveService.restore(str(tmp_path / "ck"), **CPU)
    req = next(
        r
        for p in back._planes.values()
        for r in p.requests
        if r is not None
    )
    assert req.deadline_s == 5.0


def test_unported_service_features_refuse(tmp_path):
    """What the JAX service does beyond the live plane, its durability and
    its spill refuses with its ROADMAP item."""
    cfg = SolveConfig(num_workers=2, service_lanes=2)
    svc = SolveService("vertex_cover", cfg, **CPU)
    svc.submit(erdos_renyi(12, 0.3, 0), deadline_s=5.0)
    svc.step()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
        SolveService("vertex_cover", cfg, injector=object(), **CPU)


# -- 4. deterministic scheduling -----------------------------------------------


def test_priority_admission_order_is_deterministic():
    sched = LaneScheduler("priority")
    reqs = [
        SolveRequest(ticket=0, g=None, priority=0),
        SolveRequest(ticket=1, g=None, priority=5, deadline=9),
        SolveRequest(ticket=2, g=None, priority=5, deadline=3),
        SolveRequest(ticket=3, g=None, priority=5),
        SolveRequest(ticket=4, g=None, priority=1),
    ]
    for r in reqs:
        sched.push(r)
    assert [r.ticket for r in sched.ordered()] == [2, 1, 3, 4, 0]
    fifo = LaneScheduler("fifo")
    for r in reversed(reqs):
        fifo.push(r)
    assert [r.ticket for r in fifo.ordered()] == [0, 1, 2, 3, 4]


def test_tenant_cap_skips_without_starving():
    cfg = SolveConfig(
        num_workers=2, steps_per_round=2, chunk_rounds=1, service_lanes=2,
        admission="fifo", tenant_max_lanes=1,
    )
    svc = SolveService("vertex_cover", cfg, **CPU)
    a1 = svc.submit(erdos_renyi(30, 0.5, 0), tenant="a")
    a2 = svc.submit(erdos_renyi(30, 0.5, 1), tenant="a")
    b1 = svc.submit(erdos_renyi(30, 0.5, 2), tenant="b")
    svc.step()
    st = svc.status()
    lanes = st["planes"]["(1, None)"]
    assert lanes["occupied"] == 2
    assert lanes["tickets"] == sorted([a1, b1])
    assert st["queued"] == 1
    svc.drain()
    for t in (a1, a2, b1):
        assert svc.ready(t)


def test_fpt_per_request_k_overrides_config():
    g = erdos_renyi(20, 0.3, 2)
    want, _, _ = solve_sequential(g)
    cfg = SolveConfig(num_workers=4, mode="fpt", k=want, service_lanes=2)
    svc = SolveService("vertex_cover", cfg, **CPU)
    t_yes = svc.submit(g)
    t_no = svc.submit(g, k=want - 1)
    svc.drain()
    assert svc.result(t_yes).found is True
    assert svc.result(t_no).found is False


# -- 5. the continuous path under solve_stream_session -------------------------


def test_solve_stream_session_mixed_problem_churn():
    sizes = [16, 18, 14, 20, 16, 18, 14, 20]
    probs = ["vertex_cover", "max_clique"] * 4
    gs = [erdos_renyi(n, 0.35, 40 + i) for i, n in enumerate(sizes)]
    cache = PlaneCache()
    out = solve_stream_session(
        gs, batch_size=2, problem=probs, cache=cache,
        config=SolveConfig(num_workers=4, steps_per_round=8), **CPU,
    )
    assert [r.problem for r in out] == probs
    for g, r in zip(gs, out):
        ref = (
            solve_sequential if r.problem == "vertex_cover"
            else solve_sequential_max_clique
        )
        assert r.best_size == ref(g)[0]
    assert cache.stats().planes == 2


# -- 6. live parity with the JAX service ---------------------------------------

RESULT_FIELDS = ("problem", "backend", "best_size", "found", "wall_s", "rounds",
                 "nodes_expanded", "tasks_transferred")
STATS_FIELDS = ("overflow", "overflow_count", "control_bytes_per_round",
                "transfer_rounds", "transfer_bytes_total", "transfer_bytes_per_round")


def _stream(rng, problem: str, fpt: bool):
    """A seeded request stream: sizes over two W buckets, priorities,
    superstep and wall-clock deadlines, tenants and (fpt) per-request k."""
    reqs = []
    for i in range(10):
        n = int(rng.integers(12, 31)) if i % 4 else int(rng.integers(33, 39))
        kw = {"priority": int(rng.integers(0, 3))}
        if i % 3 == 1:
            kw["deadline"] = int(rng.integers(1, 4))
        if i % 5 == 2:
            kw["deadline_s"] = float(rng.integers(2, 6))
        kw["tenant"] = ("a", "b", None)[i % 3]
        if fpt and i % 2:  # targets on both sides of the optimum
            lo, hi = (n // 2, n - 4) if problem == "vertex_cover" else (3, 7)
            kw["k"] = int(rng.integers(lo, hi))
        reqs.append((n, 0.3, 100 + i, kw))
    return reqs


@pytest.mark.parametrize(
    "problem,mode",
    [("vertex_cover", "bnb"), ("vertex_cover", "fpt"),
     ("max_clique", "bnb"), ("max_clique", "fpt")],
)
def test_live_parity_with_jax_service(problem, mode):
    fpt = mode == "fpt"
    kw = dict(num_workers=4, steps_per_round=4, chunk_rounds=2, service_lanes=3,
              tenant_max_lanes=2)
    if fpt:
        kw.update(mode="fpt", k=20 if problem == "vertex_cover" else 4)
    clock = FakeClock()  # shared: both services read the same instants
    jsvc = JaxService(problem, JaxConfig(**kw), clock=clock)
    tsvc = SolveService(problem, SolveConfig(**kw), clock=clock, **CPU)
    stream = _stream(np.random.default_rng(7), problem, fpt)
    for n, p, seed, sub in stream:
        assert jsvc.submit(jax_erdos_renyi(n, p, seed), **sub) == tsvc.submit(
            erdos_renyi(n, p, seed), **sub)
    steps = 0
    while not (jsvc.idle() and tsvc.idle()):
        clock.t += 1.0
        done_j, done_t = jsvc.step(), tsvc.step()
        assert done_t == done_j, f"step {steps}"
        assert tsvc.status() == jsvc.status()
        for t in done_j:
            want, got = jsvc.result(t), tsvc.result(t)
            for name in RESULT_FIELDS:
                assert getattr(got, name) == getattr(want, name), (t, name)
            if want.best_sol is None:
                assert got.best_sol is None
            else:
                assert (np.asarray(got.best_sol) == np.asarray(want.best_sol)).all()
            for name in STATS_FIELDS:
                assert getattr(got.stats, name) == getattr(want.stats, name), (t, name)
            assert got.stats.service.__dict__ == want.stats.service.to_dict(), t
        steps += 1
        assert steps < 500
    js, ts = jsvc.stats(), tsvc.stats()
    assert {k: ts[k] for k in js} == js
    assert js["completed"] == len(stream)
    # the stream really exercised what it claims to
    assert js["evicted"] > 0 and js["planes"] == 2
