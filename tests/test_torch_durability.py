"""The port's durable solve plane on the CPU: kill at any chunk boundary,
resume, and the result is the uninterrupted run's, the port's and the JAX
package's alike.

``tests/test_durability.py`` one for one on ``device="cpu"`` (solo bnb and
fpt resumed at every boundary, ``solve_many`` across a compaction with its
host accounting, an occupied service restored with a pending queue, the
auto-checkpoint from the config), each held field for field against the
uninterrupted port run and the uninterrupted JAX run.  The port's plane
cache builds no plane on a resume (``cache_stats()["planes"]`` stands for
the JAX package's ``PLANE_TRACES``).

Across packages: a checkpoint of each kind written by the JAX package
resumes (or restores) in the port to the JAX run's result, and a solo and a
service checkpoint written by the port resume in the JAX package to the
port run's.  What the port cannot run yet refuses: a checkpoint holding
spill state names ROADMAP item 10.

Outside the contract, as in the JAX tests: ``wall_s`` and the durability
bookkeeping (``checkpoints_written``, ``resumed_from``).  ``reduce_sweeps``
(the port's own) resumes from a port checkpoint's meta and counts from the
resume for a JAX one.
"""

import os

import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.api import SolveService as JaxService
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import PlaneCache, SolveConfig, SolverSession, SolveService
from repro_torch.checkpoint.solve import SolveCheckpoint
from repro_torch.graphs.generators import erdos_renyi

CPU = dict(device="cpu")
# checkpoint at EVERY host-sync boundary: one round per chunk, tiny rounds
CFG = dict(num_workers=4, steps_per_round=2, chunk_rounds=1, checkpoint_every=1)
MANY_SIZES = [(20, 1), (30, 2), (34, 3), (18, 4), (33, 5), (26, 6)]
SERVICE_SIZES = MANY_SIZES + [(24, 7)]
SERVICE_CFG = dict(num_workers=4, steps_per_round=2, chunk_rounds=1, service_lanes=3)


def _assert_same(a, b):
    """Equal modulo wall clock and durability bookkeeping (the JAX test's
    ``_assert_same``); ``a`` and ``b`` may come from either package."""
    assert a.best_size == b.best_size
    assert a.found == b.found
    assert a.rounds == b.rounds
    assert a.nodes_expanded == b.nodes_expanded
    assert a.tasks_transferred == b.tasks_transferred
    assert a.stats.transfer_rounds == b.stats.transfer_rounds
    assert a.stats.transfer_bytes_total == b.stats.transfer_bytes_total
    assert a.stats.overflow_count == b.stats.overflow_count
    assert (a.best_sol is None) == (b.best_sol is None)
    if a.best_sol is not None:
        assert (np.asarray(a.best_sol) == np.asarray(b.best_sol)).all()


def _steps(d):
    return sorted(
        int(p[5:]) for p in os.listdir(d)
        if p.startswith("step_") and not p.endswith(".tmp")
    )


@pytest.mark.parametrize(
    "mode_kw",
    [dict(), dict(mode="fpt", k=20)],
    ids=["bnb", "fpt"],
)
def test_solo_resume_bit_identical_at_every_boundary(tmp_path, mode_kw):
    cfg = SolveConfig(**CFG, **mode_kw)
    cache = PlaneCache()
    g = erdos_renyi(34, 0.25, seed=3)
    base = SolverSession(config=cfg, cache=cache, **CPU).solve(g)
    assert base.rounds > 3  # the run really spans several chunk boundaries
    jax_base = JaxSession(config=JaxConfig(**CFG, **mode_kw)).solve(
        jax_erdos_renyi(34, 0.25, seed=3))
    _assert_same(base, jax_base)

    d = str(tmp_path / "ck")
    r = SolverSession(config=cfg, cache=cache, **CPU).solve(g, checkpoint_dir=d)
    _assert_same(r, base)
    assert r.stats.reduce_sweeps == base.stats.reduce_sweeps
    steps = _steps(d)
    assert r.stats.checkpoints_written == len(steps) > 0

    planes = cache.stats().planes
    for s in steps:  # a kill after ANY chunk is resumable
        rr = SolverSession.resume(
            os.path.join(d, f"step_{s}"), cache=cache, checkpoint_dir=None, **CPU
        )
        _assert_same(rr, base)
        _assert_same(rr, jax_base)
        assert rr.stats.resumed_from
        # the running sum rides in the port's checkpoint
        assert rr.stats.reduce_sweeps == base.stats.reduce_sweeps
    # resuming into the warm plane cache builds no plane
    assert cache.stats().planes == planes


def test_solve_many_resume_bit_identical_across_compaction(tmp_path):
    gs = [erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES]
    cfg = SolveConfig(**CFG)
    cache = PlaneCache()
    base = SolverSession(config=cfg, cache=cache, **CPU).solve_many(gs)
    assert base.compactions >= 1  # the batch really crosses a compaction
    jax_base = JaxSession(config=JaxConfig(**CFG)).solve_many(
        [jax_erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES])
    for a, b in zip(base.results, jax_base.results):
        _assert_same(a, b)
    assert base.compactions == jax_base.compactions

    d = str(tmp_path / "ck")
    r = SolverSession(config=cfg, cache=cache, **CPU).solve_many(gs, checkpoint_dir=d)
    for a, b in zip(r.results, base.results):
        _assert_same(a, b)
    steps = _steps(d)
    assert steps and r.results[0].stats.checkpoints_written == len(steps)

    planes = cache.stats().planes
    for s in steps:
        rr = SolverSession.resume(
            os.path.join(d, f"step_{s}"), cache=cache, checkpoint_dir=None, **CPU
        )
        assert len(rr.results) == len(base.results)
        for a, b, c in zip(rr.results, base.results, jax_base.results):
            _assert_same(a, b)
            _assert_same(a, c)
        # host-side plane accounting resumes too, not just results
        assert rr.compactions == base.compactions
        assert rr.lane_stats.chunk_calls == base.lane_stats.chunk_calls
        assert rr.lane_stats.lane_chunks == base.lane_stats.lane_chunks
        assert rr.lane_stats.reduce_sweeps == base.lane_stats.reduce_sweeps
    assert cache.stats().planes == planes


def _service_base(cache):
    svc = SolveService("vertex_cover", SolveConfig(**SERVICE_CFG), cache=cache, **CPU)
    tickets = [svc.submit(erdos_renyi(n, 0.3, seed=s)) for n, s in SERVICE_SIZES]
    svc.drain()
    return {t: svc.result(t) for t in tickets}


@pytest.mark.parametrize("steps_before", [1, 4])
def test_occupied_service_restores_and_finishes_every_ticket(tmp_path, steps_before):
    """Checkpointed after 4 steps, as the JAX test is (live lanes), and
    after 1 (live lanes and a pending queue)."""
    cache = PlaneCache()
    base = _service_base(cache)
    jsvc = JaxService("vertex_cover", JaxConfig(**SERVICE_CFG))
    jt = [jsvc.submit(jax_erdos_renyi(n, 0.3, seed=s)) for n, s in SERVICE_SIZES]
    jsvc.drain()
    for t in jt:
        _assert_same(base[t], jsvc.result(t))

    # occupy the plane: live lanes AND a pending queue at checkpoint time
    svc = SolveService("vertex_cover", SolveConfig(**SERVICE_CFG), cache=cache, **CPU)
    tickets = [svc.submit(erdos_renyi(n, 0.3, seed=s)) for n, s in SERVICE_SIZES]
    done_before = []
    for _ in range(steps_before):
        done_before.extend(svc.step())
    d = str(tmp_path / "ck")
    svc.checkpoint(d)
    assert svc.tickets()  # still occupied: this checkpoint holds live lanes
    if steps_before == 1:
        assert svc.status()["queued"] > 0  # and a pending queue

    planes = cache.stats().planes
    svc2 = SolveService.restore(d, cache=cache, **CPU)
    assert svc2.tickets() == svc.tickets()
    svc2.drain()
    for t in tickets:
        _assert_same(svc2.result(t), base[t])
    assert cache.stats().planes == planes
    # tickets finished before the kill came back from the checkpoint too
    assert set(done_before) <= set(base)
    # the restored service's counters continue the checkpointed ones
    assert svc2.stats()["submitted"] == len(tickets)
    assert svc2.stats()["completed"] == len(tickets)


def test_auto_checkpoint_from_config_and_stats_fields(tmp_path):
    """checkpoint_dir in the CONFIG (not the call) also checkpoints, and the
    durability bookkeeping lands in the typed stats."""
    g = erdos_renyi(30, 0.25, seed=3)
    d = str(tmp_path / "ck")
    cfg = SolveConfig(**CFG, checkpoint_dir=d)
    r = SolverSession(config=cfg, **CPU).solve(g)
    assert r.stats.checkpoints_written == len(_steps(d)) > 0
    assert r.stats.resumed_from is None

    rr = SolverSession.resume(d, checkpoint_dir=None, **CPU)
    _assert_same(rr, r)
    assert rr.stats.resumed_from == d
    assert rr.stats.checkpoints_written == 0

    # the service's auto-checkpoint: one every checkpoint_every steps
    sd = str(tmp_path / "svc")
    svc = SolveService("vertex_cover", SolveConfig(
        **SERVICE_CFG, checkpoint_dir=sd, checkpoint_every=2), **CPU)
    svc.submit(g)
    svc.drain()
    assert _steps(sd) == list(range(2, svc.stats()["steps"] + 1, 2))


# -- across packages ------------------------------------------------------------


@pytest.mark.parametrize("mode_kw", [dict(), dict(mode="fpt", k=20)], ids=["bnb", "fpt"])
def test_jax_solo_checkpoint_resumes_in_the_port(tmp_path, mode_kw):
    d = str(tmp_path / "jax")
    jcfg = JaxConfig(**CFG, **mode_kw)
    jax_run = JaxSession(config=jcfg).solve(jax_erdos_renyi(34, 0.25, seed=3),
                                            checkpoint_dir=d)
    pd = str(tmp_path / "port")
    port_run = SolverSession(config=SolveConfig(**CFG, **mode_kw), **CPU).solve(
        erdos_renyi(34, 0.25, seed=3), checkpoint_dir=pd)
    cache = PlaneCache()
    for s in _steps(d):
        rr = SolverSession.resume(os.path.join(d, f"step_{s}"), cache=cache,
                                  checkpoint_dir=None, **CPU)
        _assert_same(rr, jax_run)
        # a JAX checkpoint carries no sweep count: it counts from the resume
        at_s = SolveCheckpoint.load(pd, s).meta["reduce_sweeps"]
        assert rr.stats.reduce_sweeps == port_run.stats.reduce_sweeps - at_s
    assert cache.stats().planes == 1


def test_jax_many_checkpoint_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "jax")
    jax_run = JaxSession(config=JaxConfig(**CFG)).solve_many(
        [jax_erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES], checkpoint_dir=d)
    steps = _steps(d)
    for s in steps:
        rr = SolverSession.resume(os.path.join(d, f"step_{s}"), checkpoint_dir=None,
                                  **CPU)
        for a, b in zip(rr.results, jax_run.results):
            _assert_same(a, b)
        assert rr.compactions == jax_run.compactions
        assert rr.lane_stats.chunk_calls == jax_run.lane_stats.chunk_calls
        assert rr.lane_stats.live_lane_chunks == jax_run.lane_stats.live_lane_chunks


def test_jax_service_checkpoint_restores_in_the_port(tmp_path):
    jcfg = JaxConfig(**SERVICE_CFG, mode="fpt", k=30)
    jsvc = JaxService("vertex_cover", jcfg)
    jt = [jsvc.submit(jax_erdos_renyi(n, 0.3, seed=s), deadline=6)
          for n, s in SERVICE_SIZES]
    for _ in range(3):
        jsvc.step()
    d = str(tmp_path / "jax")
    jsvc.checkpoint(d)
    svc = SolveService.restore(d, **CPU)
    assert svc.tickets() == jsvc.tickets()
    jsvc.drain()
    svc.drain()
    for t in jt:
        a, b = svc.result(t), jsvc.result(t)
        _assert_same(a, b)
        assert a.stats.service.deadline_hit == b.stats.service.deadline_hit
        assert a.stats.service.lane == b.stats.service.lane
    # the JAX ledger's counters are taken as they are
    st = svc.stats()
    assert st["lanes_quarantined"] == jsvc.stats()["lanes_quarantined"] == 0
    assert st["completed"] == jsvc.stats()["completed"] == len(jt)


def test_port_solo_checkpoint_resumes_in_jax(tmp_path):
    d = str(tmp_path / "port")
    port_run = SolverSession(config=SolveConfig(**CFG), **CPU).solve(
        erdos_renyi(34, 0.25, seed=3), checkpoint_dir=d)
    for s in _steps(d):
        rr = JaxSession.resume(os.path.join(d, f"step_{s}"), checkpoint_dir=None)
        _assert_same(rr, port_run)


def test_port_service_checkpoint_restores_in_jax(tmp_path):
    base = _service_base(PlaneCache())
    svc = SolveService("vertex_cover", SolveConfig(**SERVICE_CFG), **CPU)
    tickets = [svc.submit(erdos_renyi(n, 0.3, seed=s)) for n, s in SERVICE_SIZES]
    for _ in range(4):
        svc.step()
    d = str(tmp_path / "port")
    svc.checkpoint(d)
    jsvc = JaxService.restore(d)
    assert jsvc.tickets() == svc.tickets()
    jsvc.drain()
    for t in tickets:
        _assert_same(jsvc.result(t), base[t])


def test_spill_state_in_a_checkpoint_refuses(tmp_path):
    """A checkpoint with a frontier spiller's cold tier would resume with
    tasks dropped: it is refused, naming ROADMAP item 10."""
    d = str(tmp_path / "ck")
    SolverSession(config=SolveConfig(**CFG), **CPU).solve(
        erdos_renyi(34, 0.25, seed=3), checkpoint_dir=d)
    ck = SolveCheckpoint.load(d, _steps(d)[0])
    ck.arrays["spill.counters"] = np.zeros(3, np.int64)
    spilled = str(tmp_path / "spilled")
    ck.save(spilled, ck.rounds)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        SolverSession.resume(spilled, **CPU)

    svc = SolveService("vertex_cover", SolveConfig(**SERVICE_CFG), **CPU)
    svc.submit(erdos_renyi(34, 0.25, seed=3))
    svc.step()
    sd = str(tmp_path / "svc")
    svc.checkpoint(sd)
    ck = SolveCheckpoint.load(sd)
    ck.arrays["plane0/spill0.counters"] = np.zeros(3, np.int64)
    ck.save(sd, ck.rounds + 1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        SolveService.restore(sd, **CPU)


def test_launch_solve_checkpoints_and_resumes(tmp_path, capsys):
    """``repro_torch.launch.solve --checkpoint-dir`` then ``--resume``: the
    resumed solve equals the uninterrupted one, solo and batched."""
    from repro_torch.launch import solve

    flags = ["--device", "cpu", "--n", "34", "--p", "0.25", "--seed", "3",
             "--workers", "4", "--steps-per-round", "2", "--chunk-rounds", "1"]
    d = str(tmp_path / "solo")
    solve.main(flags + ["--checkpoint-dir", d, "--checkpoint-every", "1"])
    assert "checkpoints=" in capsys.readouterr().out
    base = SolverSession(config=SolveConfig(**CFG), **CPU).solve(
        erdos_renyi(34, 0.25, seed=3))
    r = solve.main(["--device", "cpu", "--resume", os.path.join(d, f"step_{_steps(d)[1]}")])
    _assert_same(r, base)
    assert "[solve] resumed from" in capsys.readouterr().out

    d = str(tmp_path / "batch")
    solve.main(flags + ["--batch", "3", "--checkpoint-dir", d, "--checkpoint-every", "1"])
    batch = SolverSession(config=SolveConfig(**CFG), **CPU).solve_many(
        [erdos_renyi(34, 0.25, seed=s) for s in (3, 4, 5)])
    rb = solve.main(["--device", "cpu", "--resume", d])
    for a, b in zip(rb.results, batch.results):
        _assert_same(a, b)
    assert "[solve] resumed batch from" in capsys.readouterr().out
