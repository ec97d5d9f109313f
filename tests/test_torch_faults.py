"""The port's fault injection and self-healing against the JAX package's.

The twin of ``tests/test_faults.py``: its eight sections, each held against
the JAX package on the same numpy-made inputs.  All of this state is
integer, so every comparison is exact; the one float, the injector's
virtual ``backoff_s``, is the same sum of the same draws.

1. **Plans**: ``FaultPlan.random`` draws equal events for a grid of seeds,
   plans cross packages through ``to_dict``/``from_dict``, and the
   validation errors match.
2. **Corruption**: ``corrupt`` flips the same bit of the same word as JAX's
   for the same plan and records, and the checked record catches it.
3. **I/O**: ``io_hook`` drives the port's store to the same retries,
   recoveries and virtual ``clock_s`` as JAX's store, on writes and reads.
4. **Crash anywhere**: a crash at each boundary leaves the solo, FPT,
   durable solo, ``solve_many`` and service results equal to the
   undisturbed port run and to JAX's, field for field, and the injector
   report equal to JAX's; ``reduce_sweeps`` of a solo solve rewinds with
   its state.  A directory written under injected write errors by either
   package resumes in the other.
5. **Spill under corruption**: ``pump_host`` conserves the task multiset
   and its ``to_flat`` is byte for byte JAX's; the saturated solve under
   both corruption kinds equals JAX's.
6. **Quarantine and shedding**: repeated crashes quarantine, shed and heal
   (4 quarantined, 0 shed at drain); the stall watchdog quarantines and
   replays; ``stats()`` and every ticket's ``ServiceStats`` equal JAX's
   step by step under a shared fake clock.
7. **Timeouts**: a timed-out request drops its ledger, a ``SolveTimeout``
   keeps its partial result, and an awaited solve never hangs.
8. **Max clique**: a crash in ``solve_many`` and in the service equals JAX
   (the fault path is generic; ``clique_expand`` is on it on the card).
"""

import asyncio
import json
import warnings

import numpy as np
import pytest

from repro.api import PlaneCache as JaxCache
from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.api import SolveService as JaxService
from repro.checkpoint import store as jax_store
from repro.core import encoding as jax_enc
from repro.core import spill as jax_spill
from repro.faults import FaultEvent as JaxEvent
from repro.faults import FaultInjector as JaxInjector
from repro.faults import FaultPlan as JaxPlan
from repro.graphs import generators as jax_gen
from repro_torch.api import PlaneCache, SolveConfig, SolverSession, SolveService
from repro_torch.api.service import AsyncSolveService, SolveTimeout
from repro_torch.checkpoint import store
from repro_torch.core import encoding as enc
from repro_torch.core import spill
from repro_torch.faults import FAULT_KINDS, FaultEvent, FaultInjector, FaultPlan
from repro_torch.graphs import generators

CPU = dict(device="cpu")
# one warm plane cache a package for the module: the cases re-solve the
# same shapes many times
_JCACHE = JaxCache()
_CACHE = PlaneCache()
_BASE: dict = {}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _record(r) -> dict:
    s = r.stats
    return {
        "best_size": int(r.best_size),
        "best_sol": (None if r.best_sol is None
                     else [int(w) for w in np.asarray(r.best_sol, np.uint32)]),
        "found": bool(r.found),
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(s.transfer_rounds),
        "transfer_bytes_total": int(s.transfer_bytes_total),
        "overflow": bool(s.overflow),
        "overflow_count": int(s.overflow_count),
        "spilled_tasks": int(s.spilled_tasks),
        "readmitted_tasks": int(s.readmitted_tasks),
        "cold_bytes_peak": int(s.cold_bytes_peak),
    }


def _plans(events, seed=0):
    """The same plan in each package: (port injector, JAX injector)."""
    plan = FaultPlan(seed=seed, events=tuple(events))
    jplan = JaxPlan.from_dict(json.loads(json.dumps(plan.to_dict())))
    return FaultInjector(plan), JaxInjector(jplan)


def _sessions(problem="vertex_cover", **kw):
    return (SolverSession(problem, config=SolveConfig(**kw), cache=_CACHE, **CPU),
            JaxSession(problem, config=JaxConfig(**kw), cache=_JCACHE))


def _graphs(n, p, seed):
    return generators.erdos_renyi(n, p, seed), jax_gen.erdos_renyi(n, p, seed)


def _quiet(fn, *a, **kw):
    """Call ``fn`` with the store's retry warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **kw)


# -- 1. plans ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 8, 123, 2**31 + 5])
def test_random_plans_equal_jax(seed):
    for kw in (dict(), dict(n_events=12, lanes=4), dict(n_events=20, horizon=7, lanes=1,
                                                          max_stall=1),
               dict(kinds=("crash", "stall"), n_events=9)):
        ours, theirs = FaultPlan.random(seed, **kw), JaxPlan.random(seed, **kw)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.counts() == theirs.counts()
        assert FaultPlan.from_dict(theirs.to_dict()) == ours
        assert JaxPlan.from_dict(ours.to_dict()) == theirs
        assert FaultInjector(ours)._rng.integers(2**32) == \
            JaxInjector(theirs)._rng.integers(2**32)


def test_plan_sort_and_validation_errors_equal_jax():
    evs = [dict(kind="io_error", at=5, op="read"), dict(kind="crash", at=1, lane=2),
           dict(kind="stall", at=1, lane=0, duration=3)]
    ours = FaultPlan(seed=3, events=tuple(FaultEvent(**e) for e in evs))
    theirs = JaxPlan(seed=3, events=tuple(JaxEvent(**e) for e in evs))
    assert [e.kind for e in ours.events] == ["crash", "stall", "io_error"]
    assert ours.to_dict() == theirs.to_dict()
    assert FAULT_KINDS == ("crash", "stall", "transfer_corrupt", "cold_corrupt", "io_error")
    for bad in (dict(kind="meteor", at=0), dict(kind="crash", at=-1),
                dict(kind="stall", at=0, duration=0), dict(kind="crash", at=0, lane=-2),
                dict(kind="io_error", at=0, op="fsync")):
        with pytest.raises(ValueError) as want:
            JaxEvent(**bad)
        with pytest.raises(ValueError) as got:
            FaultEvent(**bad)
        assert str(got.value) == str(want.value)


# -- 2. corruption -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9, 41])
def test_corrupt_flips_the_same_bit_as_jax(seed):
    rng = np.random.default_rng(seed)
    kinds = ("transfer_corrupt", "cold_corrupt")
    events = [FaultEvent(kinds[i % 2], at=i // 2) for i in range(8)]
    ours, theirs = _plans(events, seed=seed)
    for i in range(12):
        if i % 3 == 0:
            ours.step_boundary()
            theirs.step_boundary()
        rec = enc.checked_record(rng.integers(0, 2**32, size=int(rng.integers(1, 40)),
                                              dtype=np.uint32))
        for kind in kinds:
            got, hit = ours.corrupt(kind, rec)
            want, jhit = theirs.corrupt(kind, rec.copy())
            assert hit == jhit and (got == want).all()
            if hit:
                assert not enc.verify_record(got) and got is not rec
            else:
                assert got is rec
    assert ours.report() == theirs.report()
    assert ours.faults_injected == 8


# -- 3. checkpoint I/O -----------------------------------------------------------


def test_io_hook_drives_both_stores_alike(tmp_path):
    events = [FaultEvent("io_error", at=0, op="write"), FaultEvent("io_error", at=0, op="write"),
              FaultEvent("io_error", at=1, op="read"), FaultEvent("io_error", at=2)]
    ours, theirs = _plans(events, seed=5)
    tree = {"x": np.arange(6, dtype=np.int32), "y": {"z": np.ones(3, np.uint32)}}
    for inj, st, d, dev in ((ours, store, tmp_path / "t", dict(device="cpu")),
                            (theirs, jax_store, tmp_path / "j", {})):
        with pytest.warns(RuntimeWarning, match="checkpoint write"):
            st.save_checkpoint(str(d), 0, tree, retry=inj.retry_policy(),
                               fault_hook=inj.io_hook)
        inj.step_boundary()
        with pytest.warns(RuntimeWarning, match="checkpoint read"):
            back = st.restore_checkpoint(str(d), tree, 0, retry=inj.retry_policy(),
                                         fault_hook=inj.io_hook, **dev)[0]
        assert (np.asarray(back["x"]) == tree["x"]).all()
        inj.step_boundary()
        with pytest.warns(RuntimeWarning):
            st.save_checkpoint(str(d), 1, tree, retry=inj.retry_policy(),
                               fault_hook=inj.io_hook)
    assert ours.report() == theirs.report()
    rep = ours.report()
    assert rep["injected"]["io_error"] == rep["recovered"]["io_error"] == 4
    assert rep["retries"] == 4 and rep["pending"] == 0 and rep["backoff_s"] > 0


# -- 4. crash anywhere -------------------------------------------------------------

_SOLO = dict(num_workers=4, steps_per_round=2, chunk_rounds=1)
_SOLO_G = (34, 0.3, 5)  # 12 supersteps, a chunk each


def _base(key, build):
    if key not in _BASE:
        _BASE[key] = build()
    return _BASE[key]


def _crash_solve(kw, graph, events, **solve_kw):
    """One solve of ``graph`` at ``kw`` under ``events`` in both packages,
    and the port's undisturbed solve; returns (port, jax, port clean,
    port injector, jax injector)."""
    ours, theirs = _plans(events)
    ts, js = _sessions(**kw)
    tg, jg = _graphs(*graph)
    clean = _base(("solo", tuple(sorted(kw.items())), graph), lambda: ts.solve(tg))
    t_kw = {k: (v(0) if callable(v) else v) for k, v in solve_kw.items()}
    j_kw = {k: (v(1) if callable(v) else v) for k, v in solve_kw.items()}
    got = _quiet(ts.solve, tg, injector=ours, **t_kw)
    want = _quiet(js.solve, jg, injector=theirs, **j_kw)
    return got, want, clean, ours, theirs


@pytest.mark.parametrize("boundary", [0, 1, 4, 9, 12, 60])
def test_solo_crash_at_any_boundary_equals_jax(boundary):
    got, want, clean, ours, theirs = _crash_solve(
        _SOLO, _SOLO_G, [FaultEvent("crash", at=boundary)])
    assert _record(got) == _record(want) == _record(clean)
    assert got.stats.reduce_sweeps == clean.stats.reduce_sweeps
    assert ours.report() == theirs.report()
    # a chunk a superstep: the crash fires iff its boundary comes before the end
    assert ours.injected["crash"] == ours.recovered["crash"] == \
        int(max(boundary, 1) <= clean.rounds)


@pytest.mark.parametrize("boundary", [0, 5, 11])
def test_fpt_crash_keeps_the_witness(boundary):
    kw = dict(_SOLO, mode="fpt", k=28)  # the optimum: found in 14 supersteps
    got, want, clean, ours, theirs = _crash_solve(
        kw, (40, 0.25, 1), [FaultEvent("crash", at=boundary)])
    assert _record(got) == _record(want) == _record(clean)
    assert got.found and got.stats.reduce_sweeps == clean.stats.reduce_sweeps
    assert ours.report() == theirs.report() and ours.injected["crash"] == 1


@pytest.mark.parametrize("events", [
    [FaultEvent("crash", at=1)],  # before the first checkpoint: a startup replay
    [FaultEvent("crash", at=6), FaultEvent("io_error", at=2, op="read")],
    [FaultEvent("crash", at=5), FaultEvent("io_error", at=4, op="write"),
     FaultEvent("crash", at=11)],
])
def test_durable_solo_crash_reloads_the_checkpoint_as_jax(tmp_path, events):
    kw = dict(_SOLO, checkpoint_every=2)
    dirs = (str(tmp_path / "t"), str(tmp_path / "j"))
    got, want, clean, ours, theirs = _crash_solve(
        kw, _SOLO_G, events, checkpoint_dir=lambda i: dirs[i])
    assert _record(got) == _record(want) == _record(clean)
    assert got.stats.reduce_sweeps == clean.stats.reduce_sweeps
    assert got.stats.checkpoints_written == want.stats.checkpoints_written
    assert ours.report() == theirs.report()
    assert ours.report()["pending"] == 0
    assert ours.faults_injected == ours.faults_recovered == len(events)
    assert store.latest_step(dirs[0]) == jax_store.latest_step(dirs[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_written_under_io_errors_resume_across_packages(tmp_path, writer):
    kw = dict(_SOLO, checkpoint_every=1, max_rounds=9)
    events = [FaultEvent("io_error", at=2, op="write"), FaultEvent("io_error", at=5, op="write")]
    ours, theirs = _plans(events)
    ts, js = _sessions(**kw)
    tg, jg = _graphs(*_SOLO_G)
    d = str(tmp_path / "ck")
    if writer == "jax":
        _quiet(js.solve, jg, injector=theirs, checkpoint_dir=d)
        assert theirs.faults_recovered == 2
        r = SolverSession.resume(d, cache=_CACHE, device="cpu", max_rounds=10**9)
    else:
        _quiet(ts.solve, tg, injector=ours, checkpoint_dir=d)
        assert ours.faults_recovered == 2
        r = JaxSession.resume(d, cache=_JCACHE, max_rounds=10**9)
    clean = _base(("solo", tuple(sorted(_SOLO.items())), _SOLO_G),
                  lambda: ts.solve(tg))
    assert _record(r) == _record(clean)


@pytest.mark.parametrize("boundary,lane", [(0, 0), (2, 1), (5, 3), (7, 2)])
def test_solve_many_crash_equals_jax(boundary, lane):
    ts, js = _sessions(**_SOLO)
    specs = [(30, 0.3, 20), (30, 0.3, 21), (28, 0.3, 22), (16, 0.3, 23)]
    tgs, jgs = zip(*(_graphs(*s) for s in specs))
    clean = _base(("many",), lambda: ts.solve_many(list(tgs)))
    ours, theirs = _plans([FaultEvent("crash", at=boundary, lane=lane)])
    got = ts.solve_many(list(tgs), injector=ours)
    want = js.solve_many(list(jgs), injector=theirs)
    for a, b, c in zip(got.results, want.results, clean.results):
        assert _record(a) == _record(b) == _record(c)
    assert got.compactions == want.compactions
    assert ours.report() == theirs.report()
    assert ours.injected["crash"] == ours.recovered["crash"] == 1


def _service_pair(problem, kw, injectors, clock=None, **serve_kw):
    ours, theirs = injectors
    tsvc = SolveService(problem, SolveConfig(**kw, **serve_kw), cache=_CACHE,
                        clock=clock, injector=ours, **CPU)
    jsvc = JaxService(problem, JaxConfig(**kw, **serve_kw), cache=_JCACHE, clock=clock,
                      injector=theirs)
    return tsvc, jsvc


def _step_in_lockstep(tsvc, jsvc, clock=None, limit=500) -> list:
    """Step both services until idle, asserting at every step the same
    completions, status, results, ``ServiceStats`` and ``stats()``; returns
    the port's results in completion order."""
    out = []
    for _ in range(limit):
        if tsvc.idle() and jsvc.idle():
            return out
        if clock is not None:
            clock.t += 1.0
        done_t, done_j = _quiet(tsvc.step), _quiet(jsvc.step)
        assert done_t == done_j
        assert tsvc.status() == jsvc.status()
        for t in done_j:
            got, want = tsvc.result(t), jsvc.result(t)
            assert _record(got) == _record(want), t
            assert got.wall_s == want.wall_s
            assert got.stats.service.__dict__ == want.stats.service.to_dict(), t
            out.append((t, got))
        js, ts = jsvc.stats(), tsvc.stats()
        assert {k: ts[k] for k in js} == js
    raise AssertionError("the services did not drain")


@pytest.mark.parametrize("boundary,lane", [(0, 0), (2, 1), (4, 0), (7, 3)])
def test_service_crash_equals_jax_step_by_step(boundary, lane):
    kw = dict(_SOLO, service_lanes=2)
    specs = [(26, 0.3, 30 + i) for i in range(3)]
    tsvc, jsvc = _service_pair(
        "vertex_cover", kw, _plans([FaultEvent("crash", at=boundary, lane=lane)]),
        clock=FakeClock())
    for s in specs:
        tg, jg = _graphs(*s)
        assert tsvc.submit(tg) == jsvc.submit(jg)
    out = dict(_step_in_lockstep(tsvc, jsvc, tsvc._clock))
    solo = SolverSession(config=SolveConfig(**_SOLO), cache=_CACHE, **CPU)
    for t, s in enumerate(specs):
        assert _record(out[t]) == _record(solo.solve(_graphs(*s)[0]))
    inj = tsvc.injector
    assert inj.report() == jsvc.injector.report()
    st = tsvc.stats()
    assert st["lanes_quarantined"] == inj.injected["crash"] == inj.recovered["crash"]
    assert st["faults_injected"] == inj.faults_injected
    assert sum(r.stats.service.lanes_quarantined for r in out.values()) == \
        st["lanes_quarantined"]


# -- 5. spill under corruption ---------------------------------------------------


def _pool(P=4, CAP=32, W=1, per_worker=30):
    masks = np.zeros((P, CAP, W), np.uint32)
    sols = np.zeros((P, CAP, W), np.uint32)
    depths = np.zeros((P, CAP), np.int32)
    active = np.zeros((P, CAP), bool)
    for w in range(P):
        for s in range(per_worker):
            masks[w, s] = w * CAP + s + 1
            depths[w, s] = (w * per_worker + s) % 24
            active[w, s] = True
    return masks, sols, depths, active


def _keys(masks, depths, active):
    return sorted((int(masks[w, s, 0]), int(depths[w, s])) for w, s in zip(*np.nonzero(active)))


@pytest.mark.parametrize("seed", [9, 10])
def test_pump_host_under_corruption_equals_jax(seed):
    events = [FaultEvent("cold_corrupt", at=0)] * 3 + [FaultEvent("transfer_corrupt", at=0)] * 3
    ours, theirs = _plans(events, seed=seed)
    kw = dict(chunk_rounds=1, steps_per_round=2, lanes=1, donate_k=1)
    sp = spill.FrontierSpiller(enc.make_codec("optimized", 12), 4, 32, (0.25, 0.75),
                               injector=ours, **kw)
    jsp = jax_spill.FrontierSpiller(jax_enc.make_codec("optimized", 12), 4, 32, (0.25, 0.75),
                                    injector=theirs, **kw)
    pools, jpools = _pool(), _pool()
    before = _keys(pools[0], pools[2], pools[3])
    assert sp.pump_host(*pools) and jsp.pump_host(*jpools)
    recovered = _keys(pools[0], pools[2], pools[3])
    while sp.cold_tasks:
        flat, jflat = sp.to_flat(), jsp.to_flat()
        assert sorted(flat) == sorted(jflat)
        for name in flat:
            assert flat[name].dtype == jflat[name].dtype
            assert flat[name].tobytes() == np.asarray(jflat[name]).tobytes(), name
        empty = [np.zeros_like(a) for a in pools]
        jempty = [np.zeros_like(a) for a in pools]
        assert sp.pump_host(*empty) and jsp.pump_host(*jempty)
        for a, b in zip(empty, jempty):
            assert (a == b).all()
        recovered += _keys(empty[0], empty[2], empty[3])
    assert sorted(recovered) == before
    assert sp.readmitted_total == sp.spilled_total == jsp.spilled_total
    assert sp.delivery_retries == jsp.delivery_retries == ours.retries == ours.faults_injected
    for kind in ("cold_corrupt", "transfer_corrupt"):
        assert ours.injected[kind] == ours.recovered[kind] >= 1
    assert ours.report() == theirs.report()


@pytest.mark.parametrize("events", [
    [FaultEvent("transfer_corrupt", at=1), FaultEvent("cold_corrupt", at=2)],
    [FaultEvent("cold_corrupt", at=0), FaultEvent("cold_corrupt", at=3),
     FaultEvent("transfer_corrupt", at=4), FaultEvent("crash", at=5)],
])
def test_saturated_solve_under_corruption_equals_jax(events):
    kw = dict(num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=16,
              frontier_spill=True)
    got, want, clean, ours, theirs = _crash_solve(kw, (40, 0.28, 0), events)
    assert clean.stats.spilled_tasks > 0
    assert _record(got) == _record(want) == _record(clean)
    assert ours.report() == theirs.report()
    assert ours.faults_injected == ours.faults_recovered == len(events)


# -- 6. quarantine, shedding, the watchdog ------------------------------------------


def test_repeated_crashes_quarantine_shed_and_heal_as_jax():
    kw = dict(_SOLO, service_lanes=2)
    events = [FaultEvent("crash", at=2 + i, lane=i % 2) for i in range(4)]
    clock = FakeClock()
    tsvc, jsvc = _service_pair("vertex_cover", kw, _plans(events), clock=clock)
    for i in range(4):
        tg, jg = _graphs(28, 0.3, 50 + i)
        assert tsvc.submit(tg) == jsvc.submit(jg)
    seen_shed = []
    for _ in range(500):
        if tsvc.idle():
            break
        clock.t += 1.0
        assert _quiet(tsvc.step) == _quiet(jsvc.step)
        js, ts = jsvc.stats(), tsvc.stats()
        assert {k: ts[k] for k in js} == js
        seen_shed.append(ts["lanes_shed"])
        for tp, jp in zip(tsvc._planes.values(), jsvc._planes.values()):
            assert (tp.quarantined, tp.shed, tp.fault_hits, tp.fault_free) == \
                (jp.quarantined, jp.shed, jp.fault_hits, jp.fault_free)
    s = tsvc.stats()
    assert s["lanes_quarantined"] == 4 and max(seen_shed) >= 1
    assert s["faults_injected"] == s["faults_recovered"] == 4
    assert s["completed"] == 4 and s["lanes_shed"] == 0
    for t in range(4):
        got, want = tsvc.result(t), jsvc.result(t)
        assert _record(got) == _record(want)
        assert got.stats.service.__dict__ == want.stats.service.to_dict()


@pytest.mark.parametrize("duration,stall_chunks", [(4, 2), (1, 2), (3, 3)])
def test_stall_watchdog_equals_jax_step_by_step(duration, stall_chunks):
    kw = dict(_SOLO, service_lanes=2)
    clock = FakeClock()
    tsvc, jsvc = _service_pair(
        "vertex_cover", kw, _plans([FaultEvent("stall", at=2, lane=1, duration=duration)]),
        clock=clock, lane_stall_chunks=stall_chunks)
    specs = [(28, 0.3, 60 + i) for i in range(3)]
    for s in specs:
        tg, jg = _graphs(*s)
        assert tsvc.submit(tg) == jsvc.submit(jg)
    out = dict(_step_in_lockstep(tsvc, jsvc, clock))
    solo = SolverSession(config=SolveConfig(**_SOLO), cache=_CACHE, **CPU)
    for t, s in enumerate(specs):
        assert _record(out[t]) == _record(solo.solve(_graphs(*s)[0]))
    inj = tsvc.injector
    assert inj.injected["stall"] == inj.recovered["stall"] == 1
    assert inj.report() == jsvc.injector.report()
    # a window shorter than the watchdog's patience drains without a quarantine
    assert tsvc.stats()["lanes_quarantined"] == int(duration >= stall_chunks)


def test_lane_slice_is_a_copy_and_write_back_restores_it():
    from repro_torch.core import engine
    from repro_torch.core.superstep import (
        lane_slice,
        lane_swap_in,
        lane_write_back,
        make_vacant_lanes,
        worker_state_to_flat,
    )
    from repro_torch.problems.registry import get_problem

    spec = get_problem("vertex_cover")
    lanes = make_vacant_lanes(2, 4, 16, 1, "cpu")
    g = generators.erdos_renyi(20, 0.3, 1)
    lane_swap_in(lanes, 1, engine.make_instance_state(spec, g, 4, 16, 1, 99, "cpu"), 7)
    lanes.rounds[1] = 5
    snap = lane_slice(lanes, 1)
    want = worker_state_to_flat(snap)
    lane_swap_in(lanes, 1, engine.make_instance_state(spec, g, 4, 16, 1, 3, "cpu"), 7)
    assert worker_state_to_flat(snap).keys() == want.keys()
    for name, arr in worker_state_to_flat(snap).items():
        assert (arr == want[name]).all(), name  # the snapshot did not follow
    lane_write_back(lanes, 1, snap, True, 5)
    back = worker_state_to_flat(lane_slice(lanes, 1))
    for name, arr in back.items():
        assert (arr == want[name]).all(), name
    assert bool(lanes.done[1]) and int(lanes.rounds[1]) == 5 and lanes.tag[1] == 7


# -- 7. timeouts -----------------------------------------------------------------


def _timeout_pair():
    kw = dict(_SOLO, service_lanes=1, admission="fifo", request_timeout_s=5.0)
    clock = FakeClock()
    tsvc, jsvc = _service_pair("vertex_cover", kw, _plans([FaultEvent("crash", at=0)]),
                               clock=clock)
    for s in [(30, 0.45, 3), (20, 0.3, 4), (22, 0.3, 5)]:
        tg, jg = _graphs(*s)
        assert tsvc.submit(tg) == jsvc.submit(jg)
    # ticket 0 takes the lane, crashes at the first boundary and is
    # re-queued with its ledger
    assert _quiet(tsvc.step) == _quiet(jsvc.step) == []
    assert tsvc._req_faults == jsvc._req_faults == {0: [1, 1, 1]}
    return tsvc, jsvc, clock


def _timeouts(tsvc, jsvc, done) -> list:
    out = []
    for t in done:
        with pytest.raises(SolveTimeout) as got:
            tsvc.result(t)
        with pytest.raises(Exception) as want:
            jsvc.result(t)
        assert type(want.value).__name__ == "SolveTimeout"
        assert str(got.value) == str(want.value)
        out.append(got.value)
    return out


def test_queued_timeout_drops_the_ledger_as_jax():
    tsvc, jsvc, clock = _timeout_pair()
    clock.t = 10.0  # every request still queued: swept with no partial
    done = _quiet(tsvc.step)
    assert done == _quiet(jsvc.step) and sorted(done) == [0, 1, 2]
    assert tsvc._req_faults == jsvc._req_faults == {}
    assert all(e.result is None and "still queued" in str(e)
               for e in _timeouts(tsvc, jsvc, done))
    assert tsvc.stats()["timed_out"] == jsvc.stats()["timed_out"] == 3
    assert tsvc.idle()


def test_on_lane_timeout_keeps_its_partial_and_ledger_as_jax():
    tsvc, jsvc, clock = _timeout_pair()
    # the quarantined lane is rehabilitated for ticket 0 (the floor of one
    # usable lane), which runs a chunk, then times out on the lane
    assert _quiet(tsvc.step) == _quiet(jsvc.step) == []
    clock.t = 10.0
    done = _quiet(tsvc.step)
    assert done == _quiet(jsvc.step) and sorted(done) == [0, 1, 2]
    assert tsvc._req_faults == jsvc._req_faults == {}
    errs = dict(zip(done, _timeouts(tsvc, jsvc, done)))
    partial = errs[0].result
    assert partial is not None and partial.rounds >= 1 and "on a lane" in str(errs[0])
    svc_stats = partial.stats.service
    assert (svc_stats.faults_injected, svc_stats.faults_recovered,
            svc_stats.lanes_quarantined) == (1, 1, 1)
    assert not svc_stats.deadline_hit and not svc_stats.wall_deadline_hit
    assert errs[1].result is None and errs[2].result is None
    assert tsvc.stats()["timed_out"] == jsvc.stats()["timed_out"] == 3


def test_async_awaited_solve_never_hangs():
    async def scenario():
        cfg = SolveConfig(**_SOLO, service_lanes=1, request_timeout_s=1e-4)
        svc = SolveService("vertex_cover", cfg, cache=_CACHE, **CPU)
        async with AsyncSolveService(svc) as asvc:
            out = await asyncio.gather(
                asvc.solve(generators.erdos_renyi(34, 0.5, 7)), return_exceptions=True)
        assert isinstance(out[0], SolveTimeout)
        inj = FaultInjector(FaultPlan(events=(FaultEvent("crash", at=1),)))
        svc_ok = SolveService("vertex_cover", cfg.replace(request_timeout_s=3600.0),
                              cache=_CACHE, injector=inj, **CPU)
        async with AsyncSolveService(svc_ok) as asvc:
            r = await asvc.solve(generators.erdos_renyi(16, 0.3, 1))
        assert r.found and inj.faults_recovered == inj.faults_injected

    asyncio.run(scenario())


# -- 8. max clique -------------------------------------------------------------------


@pytest.mark.parametrize("boundary,lane", [(1, 0), (3, 1)])
def test_max_clique_crash_in_solve_many_and_the_service_equals_jax(boundary, lane):
    kw = dict(num_workers=4, steps_per_round=4, chunk_rounds=1)
    specs = [(22, 0.45, 70), (24, 0.45, 71)]
    ts, js = _sessions("max_clique", **kw)
    tgs, jgs = zip(*(_graphs(*s) for s in specs))
    clean = _base(("clique_many",), lambda: ts.solve_many(list(tgs)))
    ours, theirs = _plans([FaultEvent("crash", at=boundary, lane=lane)])
    got = ts.solve_many(list(tgs), injector=ours)
    want = js.solve_many(list(jgs), injector=theirs)
    for a, b, c in zip(got.results, want.results, clean.results):
        assert _record(a) == _record(b) == _record(c)
    assert ours.report() == theirs.report() and ours.faults_recovered == 1

    tsvc, jsvc = _service_pair("max_clique", kw, _plans([FaultEvent("crash", at=boundary,
                                                                    lane=lane)]),
                               clock=FakeClock(), service_lanes=2)
    for tg, jg in zip(tgs, jgs):
        assert tsvc.submit(tg) == jsvc.submit(jg)
    out = dict(_step_in_lockstep(tsvc, jsvc, tsvc._clock))
    for t, c in enumerate(clean.results):
        assert _record(out[t]) == _record(c)
    assert tsvc.stats()["lanes_quarantined"] == 1


# -- the CLI -------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [False, True])
def test_launch_solve_chaos_flags_print_the_jax_lines(capsys, monkeypatch, tmp_path, batch):
    """``--chaos N --chaos-seed S`` draws the JAX CLI's plan and prints its
    ``[solve]`` lines and chaos report, solo and batched."""
    from repro.launch import solve as jax_solve
    from repro_torch.launch import solve

    flags = ["--n", "48", "--p", "0.28", "--workers", "4", "--steps-per-round", "2",
             "--chunk-rounds", "1", "--chaos", "8", "--chaos-seed", "3"]
    flags += ["--batch", "2"] if batch else []

    def lines():
        out = capsys.readouterr().out.splitlines()
        return [x.split(" wall=")[0].split(" in ")[0] for x in out
                if x.startswith("[solve]") and "cache:" not in x]

    _quiet(solve.main, ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "t")] + flags)
    ours = lines()
    monkeypatch.setattr("sys.argv", ["solve", "--checkpoint-dir", str(tmp_path / "j")] + flags)
    _quiet(jax_solve.main)
    assert ours == lines()
    assert any(x.startswith("[solve] chaos report:") for x in ours)
