"""The port's session-level serving front on the CPU.

* ``submit``/``poll``/``flush``/``result``/``pending``: each ticket's result
  equals its ``solve_many`` result, field for field;
* ``solve_stream_session`` with mixed problems on one shared cache equals the
  JAX package's, and ``serving.balancer.solve_stream`` drives it;
* ``serve()`` refuses a non-spmd backend and hands its device and cache to
  the service; ``SolveService`` with ``device=None`` raises without CUDA;
* ``python -m repro_torch.launch.serve --smoke --device cpu`` prints its
  ``[serve]`` lines; ``--checkpoint-dir`` then ``--resume`` finishes the
  checkpointed tickets.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import SolveConfig as JaxConfig
from repro.api import solve_stream_session as jax_solve_stream_session
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import (
    PlaneCache,
    SolveConfig,
    SolveService,
    SolverSession,
    solve_stream_session,
)
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.problems.sequential import solve_sequential
from repro_torch.serving.balancer import solve_stream

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("problem", "backend", "best_size", "found", "rounds", "nodes_expanded",
          "tasks_transferred")
STATS = ("overflow", "overflow_count", "control_bytes_per_round",
         "transfer_rounds", "transfer_bytes_total", "transfer_bytes_per_round")


def _same(want, got):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert (np.asarray(got.best_sol) == np.asarray(want.best_sol)).all()
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name


@pytest.mark.parametrize("problem", ["vertex_cover", "max_clique"])
def test_submit_poll_flush_result_round_trip(problem):
    cfg = SolveConfig(num_workers=4, steps_per_round=8, batch_size=2)
    session = SolverSession(problem=problem, config=cfg, device="cpu")
    gs = [erdos_renyi(18, 0.3, s) for s in range(3)]
    assert session.poll() == [] and session.flush() == [] and session.pending() == 0
    tickets = [session.submit(g) for g in gs]
    assert session.pending() == 3
    polled = session.poll()  # two of three fill a batch_size=2 plane
    assert len(polled) == 2 and session.pending() == 1
    flushed = session.flush()
    assert len(flushed) == 1 and session.pending() == 0
    assert sorted(polled + flushed) == tickets
    # the batcher admits largest-first: replay each plane with solve_many
    for batch in (polled, flushed):
        many = SolverSession(problem=problem, config=cfg, device="cpu").solve_many(
            [gs[t] for t in batch])
        for t, want in zip(batch, many.results):
            _same(want, session.result(t))
    with pytest.raises(KeyError):
        session.result(tickets[0])  # result() pops


def test_solve_stream_session_matches_jax():
    sizes = [16, 18, 14, 20, 40, 18]
    probs = ["vertex_cover", "max_clique"] * 3
    kw = dict(num_workers=4, steps_per_round=8)
    cache = PlaneCache()
    got = solve_stream_session(
        [erdos_renyi(n, 0.35, 40 + i) for i, n in enumerate(sizes)],
        batch_size=2, problem=probs, cache=cache, config=SolveConfig(**kw),
        device="cpu",
    )
    want = jax_solve_stream_session(
        [jax_erdos_renyi(n, 0.35, 40 + i) for i, n in enumerate(sizes)],
        batch_size=2, problem=probs, config=JaxConfig(**kw),
    )
    assert [r.problem for r in got] == probs
    for w, g in zip(want, got):
        _same(w, g)
        assert g.stats.service.lane == w.stats.service.lane
        assert g.stats.service.plane == w.stats.service.plane
    # one plane function per problem, shared by both of its W buckets
    assert cache.stats().planes == 2
    # the balancer's stream entry point drives the same services
    again = solve_stream(
        [erdos_renyi(n, 0.35, 40 + i) for i, n in enumerate(sizes)], 2,
        problem=probs, device="cpu", **kw,
    )
    for a, b in zip(got, again):
        _same(a, b)


def test_solve_stream_session_sequential_fallback():
    gs = [erdos_renyi(14, 0.3, s) for s in range(3)]
    out = solve_stream_session(gs, 2, backend="sequential", device="cpu")
    assert [r.backend for r in out] == ["sequential"] * 3
    assert [r.best_size for r in out] == [solve_sequential(g)[0] for g in gs]


def test_serve_needs_spmd_and_passes_device_and_cache():
    with pytest.raises(ValueError, match="spmd"):
        SolverSession(backend="sequential", device="cpu").serve()
    session = SolverSession(config=SolveConfig(num_workers=4), device="cpu")
    g = erdos_renyi(20, 0.3, 0)
    solo = session.solve(g)
    svc = session.serve(service_lanes=2)
    assert svc.device.type == "cpu" and svc.cache is session.cache
    assert svc.config.service_lanes == 2
    t = svc.submit(g)
    svc.drain()
    _same(solo, svc.result(t))
    # serve() passes an injector through to the service, which heals it
    from repro_torch.faults import FaultEvent, FaultInjector, FaultPlan

    inj = FaultInjector(FaultPlan(events=(FaultEvent("crash", at=1),)))
    svc = session.serve(service_lanes=2, injector=inj)
    assert svc.injector is inj
    t = svc.submit(g)
    svc.drain()
    _same(solo, svc.result(t))
    assert inj.injected["crash"] == inj.recovered["crash"] == 1


def test_service_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolveService("vertex_cover")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_stream_session([erdos_renyi(10, 0.3, 0)], 2)
    assert SolveService("vertex_cover", device="cpu").device.type == "cpu"


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )


def test_launch_serve_smoke_on_cpu():
    out = _serve("--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("[serve]")]
    assert len(lines) == 2
    assert lines[0].startswith("[serve] 12 requests in ")
    assert "evicted 0" in lines[0] and "latency p50" in lines[0]
    assert lines[1].startswith("[serve] cache: {")


def test_launch_serve_answers_every_request_correctly():
    from repro_torch.launch import serve
    from repro_torch.problems.sequential import solve_sequential_max_clique

    argv = ["--smoke", "--device", "cpu", "--requests", "6", "--json"]
    out = serve.main(argv)
    args = serve.parse_args(argv)
    graphs = [g for _, g in serve.build_requests(args, np.random.default_rng(args.seed))]
    assert out["best_sizes"] == [solve_sequential_max_clique(g)[0] for g in graphs]
    assert out["cache"]["planes"] == 1


def test_launch_serve_checkpoints_and_resumes(tmp_path):
    """``--checkpoint-dir`` writes the live service's checkpoints; ``--resume``
    restores one and finishes its in-flight and queued tickets, each equal
    to the sequential reference, beside a new stream."""
    from repro_torch.checkpoint.solve import SolveCheckpoint
    from repro_torch.launch import serve
    from repro_torch.problems.sequential import solve_sequential_max_clique

    d = str(tmp_path / "ck")
    out = serve.main(["--smoke", "--device", "cpu", "--requests", "6", "--json",
                      "--checkpoint-dir", d, "--checkpoint-every", "1"])
    assert out["resumed_tickets"] == 0
    step_dir = sorted(tmp_path.glob("ck/step_*"))[0]
    ck = SolveCheckpoint.load(str(step_dir))
    owed = sorted(
        [m["ticket"] for p in ck.meta["planes"] for m in p["requests"] if m is not None]
        + [m["ticket"] for m in ck.meta["queue"]]
    )
    assert owed
    back = serve.main(["--smoke", "--device", "cpu", "--requests", "2", "--json",
                       "--resume", str(step_dir)])
    assert back["resumed_tickets"] == len(owed)
    assert back["resumed_best_sizes"] == [
        solve_sequential_max_clique(ck.unpack_graph(t))[0] for t in owed
    ]
    assert len(back["best_sizes"]) == 2
