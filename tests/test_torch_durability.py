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
port run's.  A checkpoint whose cold tier (spill state) fails its CRC32
check refuses to resume, as in the JAX package; spilled checkpoints that
resume are ``tests/test_torch_spill_durability.py``.

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


def test_port_service_checkpoint_gives_jax_its_own_stats_keys(tmp_path):
    """A JAX service restored from a port checkpoint reports exactly the
    ``stats()`` keys of one restored from a JAX checkpoint: the port's own
    ``supersteps`` counter stays out of JAX's ``stats`` and comes back in
    the port's own restore."""
    cfg = dict(num_workers=2, steps_per_round=2, chunk_rounds=1, service_lanes=2)
    graphs = [(24, 0.3, s) for s in range(1, 5)]
    svc = SolveService("vertex_cover", SolveConfig(**cfg), **CPU)
    jsvc = JaxService("vertex_cover", JaxConfig(**cfg))
    for n, p, s in graphs:
        svc.submit(erdos_renyi(n, p, seed=s))
        jsvc.submit(jax_erdos_renyi(n, p, seed=s))
    for _ in range(3):
        svc.step()
        jsvc.step()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    svc.checkpoint(port_dir)
    jsvc.checkpoint(jax_dir)
    from_port, from_jax = JaxService.restore(port_dir), JaxService.restore(jax_dir)
    from_port.drain()
    from_jax.drain()
    assert sorted(from_port.stats()) == sorted(from_jax.stats())
    # the port's own restore keeps its counter, to continue it
    ours = SolveService.restore(port_dir, **CPU)
    assert ours.stats()["supersteps"] == svc.stats()["supersteps"] > 0
    ours.drain()
    svc.drain()
    assert ours.stats()["supersteps"] == svc.stats()["supersteps"]


def test_port_many_checkpoint_resumes_in_jax(tmp_path):
    """A port ``"many"`` checkpoint whose meta holds finalized results (the
    first bucket's, and the lanes collected at a compaction) resumes in the
    JAX package, whose ``EngineResult(**d)`` takes no port-only field."""
    d = str(tmp_path / "port")
    port_run = SolverSession(config=SolveConfig(**CFG), **CPU).solve_many(
        [erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES], checkpoint_dir=d)
    last = _steps(d)[-1]
    assert SolveCheckpoint.load(d, last).meta["results"]
    rr = JaxSession.resume(os.path.join(d, f"step_{last}"), checkpoint_dir=None)
    for a, b in zip(rr.results, port_run.results):
        _assert_same(a, b)
    assert rr.compactions == port_run.compactions


def test_spill_state_in_a_checkpoint_refuses(tmp_path):
    """A checkpoint whose cold tier holds a record that fails its CRC32
    check refuses to resume (``PayloadCorruptionError``), in the port as in
    the JAX package: a rotten task is never searched on."""
    from repro.core.encoding import PayloadCorruptionError as JaxCorruption
    from repro_torch.core.encoding import PayloadCorruptionError

    def rot(arrays, prefix):
        name = next(k for k, v in sorted(arrays.items())
                    if k.startswith(prefix) and ".w" in k and v.shape[0])
        arrays[name] = arrays[name].copy()
        arrays[name][0, 0] ^= np.uint32(1 << 31)

    # 2 workers at capacity 16: the cold tier holds records at step 8
    spill_cfg = dict(num_workers=2, steps_per_round=2, chunk_rounds=2, capacity=16,
                     frontier_spill=True, checkpoint_every=1)
    d = str(tmp_path / "ck")
    SolverSession(config=SolveConfig(**spill_cfg, max_rounds=8), **CPU).solve(
        erdos_renyi(40, 0.28, seed=0), checkpoint_dir=d)
    ck = SolveCheckpoint.load(d)
    rot(ck.arrays, "spill.")
    spilled = str(tmp_path / "spilled")
    ck.save(spilled, ck.rounds)
    with pytest.raises(PayloadCorruptionError):
        SolverSession.resume(spilled, checkpoint_dir=None, **CPU)
    with pytest.raises(JaxCorruption):
        JaxSession.resume(spilled, checkpoint_dir=None)

    svc = SolveService("vertex_cover", SolveConfig(**spill_cfg, service_lanes=2), **CPU)
    svc.submit(erdos_renyi(40, 0.28, seed=0))
    for _ in range(4):
        svc.step()
    sd = str(tmp_path / "svc")
    svc.checkpoint(sd)
    ck = SolveCheckpoint.load(sd)
    rot(ck.arrays, "plane0/spill0.")
    ck.save(sd, ck.rounds + 1)
    with pytest.raises(PayloadCorruptionError):
        SolveService.restore(sd, step=ck.rounds + 1, **CPU)
    with pytest.raises(JaxCorruption):
        JaxService.restore(sd, step=ck.rounds + 1)


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
