"""The port's spans (``repro_torch.telemetry``) and the service's counters.

* Off (no profiler, no ``recording()``) a whole solve and a service run
  record nothing and open no range or CUDA event: one check a span.
* Under a CPU ``torch.profiler`` every span of the solve plane, the center,
  the data plane and the service is recorded with its parent and ids, and
  each is a ``user_annotation`` event of the exported trace.
* Answers and the final lane state are bit-identical with the recorder on
  and off, on one process and on the mesh.
* The benchmark's span readers read a traced tiny run of each cell they
  list, and nothing of an untraced one.
* ``SolveService.stats()``'s ``nodes_expanded``, ``lane_supersteps`` and
  ``busy_lane_supersteps`` equal what the benchmark's service driver
  computes from outside the program.
* ``launch/profile.py`` gives device time and idle gaps to the innermost
  range.
"""

import collections
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "perfbench" / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

PARENTS = {
    "service.step": None,
    "service.admit": "service.step",
    "service.retire": "service.step",
    "plane.chunk": "service.step",
    "plane.superstep": "plane.chunk",
    "plane.freeze": "plane.chunk",
    "plane.done_read": "plane.chunk",
    **{f"explore.{k}": "plane.superstep" for k in ("pop", "expand", "select", "push")},
    **{f"center.{k}": "plane.superstep" for k in ("status", "match", "done")},
    **{f"transfer.{k}": "plane.superstep" for k in ("pop", "push")},
}
RESULT_FIELDS = ("best_size", "found", "rounds", "nodes_expanded", "tasks_transferred")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.clear()
    yield
    telemetry.clear()


def _graphs():
    from repro_torch.graphs.generators import erdos_renyi

    return [erdos_renyi(24, 0.2, s) for s in range(3)]


def _service_run():
    """Three instances through a 2-lane service: admissions, vacant and
    finished lanes frozen inside chunks, retirements."""
    from repro_torch.api import SolveConfig, SolveService

    cfg = SolveConfig(service_lanes=2, num_workers=4, steps_per_round=2, chunk_rounds=2)
    svc = SolveService("vertex_cover", cfg, device="cpu")
    tickets = [svc.submit(g) for g in _graphs()]
    done = svc.drain()
    assert sorted(done) == tickets
    lanes = next(iter(svc._planes.values())).lanes
    return tickets, {t: svc.result(t) for t in done}, lanes


def _solo_run():
    from repro_torch.api import SolveConfig, SolverSession

    cfg = SolveConfig(num_workers=4, steps_per_round=2, chunk_rounds=2)
    return SolverSession("vertex_cover", config=cfg, device="cpu").solve(_graphs()[0])


def _same(a, b) -> None:
    for name in RESULT_FIELDS:
        assert getattr(a, name) == getattr(b, name), name
    assert np.array_equal(np.asarray(a.best_sol), np.asarray(b.best_sol))


def test_off_a_span_is_one_shared_null_context(monkeypatch):
    assert telemetry.span("a") is telemetry.span("b", torch.device("cpu"), ticket=3)
    opened = []
    monkeypatch.setattr(telemetry, "_Open", lambda *a: opened.append(a))

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created with the recorder off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _service_run()
    _solo_run()
    assert opened == [] and telemetry.spans() == []


def test_the_profiler_records_every_span_with_its_parent(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        tickets, _, _ = _service_run()
    spans = telemetry.spans()
    assert {s.name for s in spans} == set(PARENTS)
    for s in spans:
        assert s.parent == PARENTS[s.name], (s.name, s.parent)
        assert s.end_ns >= s.start_ns and s.events is None
        assert s.stream_ms == s.host_ms
    assert sorted(s.ids["ticket"] for s in spans if s.name == "service.admit") == tickets
    assert sum(s.ids["lanes"] for s in spans if s.name == "service.retire") == len(tickets)
    chunks = [s for s in spans if s.name == "plane.chunk"]
    assert chunks and all(s.ids == {"lanes": 2, "workers": 4} for s in chunks)
    # every explore round opens its four spans inside a superstep
    per = collections.Counter(s.name for s in spans)
    assert per["explore.pop"] == per["explore.push"] == 2 * per["plane.superstep"]
    assert per["center.match"] == per["transfer.push"] == per["plane.superstep"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marked = collections.Counter(e["name"] for e in events
                                 if e.get("cat") == "user_annotation" and e["name"] in PARENTS)
    assert marked == per


def test_answers_and_lane_state_are_bit_identical_with_the_recorder_on():
    tickets, off, lanes_off = _service_run()
    solo_off = _solo_run()
    assert telemetry.spans() == []
    with telemetry.recording():
        _, on, lanes_on = _service_run()
        solo_on = _solo_run()
    assert telemetry.span("a") is telemetry.span("b")  # off again
    for t in tickets:
        _same(off[t], on[t])
    _same(solo_off, solo_on)
    for a, b in zip(lanes_off.worker.frontier + lanes_off.worker[1:],
                    lanes_on.worker.frontier + lanes_on.worker[1:]):
        assert torch.equal(a, b)
    assert torch.equal(lanes_off.done, lanes_on.done)
    assert torch.equal(lanes_off.rounds, lanes_on.rounds)
    spans = telemetry.spans()
    # the solo plane's chunk has no service around it
    assert spans[-1].name == "plane.chunk" and spans[-1].parent is None
    assert {s.name for s in spans} == set(PARENTS)
    assert telemetry.spans() == spans  # reading does not clear
    telemetry.clear()
    assert telemetry.spans() == []


def test_the_mesh_opens_the_center_and_data_plane_spans():
    from repro_torch.launch.mesh import spawn_mesh

    import _torch_mesh_jobs as jobs

    # two workers that exchange tasks (2 transfers) in 4 supersteps
    graph, kw = {"n": 30, "p": 0.2, "seed": 0}, {"num_workers": 2, "steps_per_round": 2,
                                                  "chunk_rounds": 2}
    ranks = spawn_mesh(jobs.spans_of_solve, 2, device="cpu", timeout_s=300.0,
                       args=(graph, kw))
    from repro_torch.api import SolveConfig, SolverSession

    session = SolverSession("vertex_cover", config=SolveConfig(**kw), device="cpu")
    want = jobs.result_dict(session.solve(jobs._graph(graph)))
    assert want["tasks_transferred"] > 0
    for r in ranks:
        assert r["result"] == want
        names = {name for name, _ in r["spans"]}
        assert names >= {"center.status", "center.match", "center.done", "transfer.pop",
                         "transfer.push", "plane.superstep", "explore.expand"}
        for name, parent in r["spans"]:
            if name.split(".")[0] in ("center", "transfer", "explore"):
                assert parent == "plane.superstep", (name, parent)


def _cells(name: str) -> list:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(m for m in bench["per_layer"] if m["name"] == name)["workloads"]


SPAN_READERS = ("frontier_ms", "center_ms", "transfer_ms", "retire_ms")


@pytest.mark.parametrize("name,cell", [(m, c) for m in SPAN_READERS for c in _cells(m)])
def test_span_readers_read_a_traced_run_and_nothing_untraced(name, cell):
    from conftest import run_tiny

    from perfbench.bench import find

    # at 16 vertices the clique service retires lanes inside the traced step
    n = 16 if cell.startswith("mc-") else None
    line, _ = run_tiny(cell, trace=True, n=n)
    out = json.loads(line)
    assert out["correct"] is True
    value = out["metrics"][name]["value"]
    assert value > 0 and value == find(ROOT, "metrics", name).read({})
    telemetry.clear()
    line, _ = run_tiny(cell, trace=False, n=n)
    assert json.loads(line)["correct"] is True
    assert find(ROOT, "metrics", name).read({}) is None


@pytest.mark.parametrize("cell", ["vc-gnp600-lanes32", "mc-phat300-lanes64"])
def test_service_counters_equal_the_harness_reading(cell, monkeypatch):
    """The service driver of the benchmark, run on a service that snapshots
    ``stats()`` after each step: the window's counter deltas equal the
    driver's node count and its chunks' lane-supersteps."""
    import repro_torch.api as api
    from conftest import tiny

    from perfbench.bench import find

    snaps = []

    class Snapshots(api.SolveService):
        def step(self):
            done = super().step()
            snaps.append(self.stats())
            return done

    monkeypatch.setattr(api, "SolveService", Snapshots)
    config, traffic, _, _ = tiny(cell)
    obs = find(ROOT, "drivers", traffic["entry"]).run(
        config, traffic, seed=2**31 + 5, seconds=0.2, trace=False,
        device=torch.device("cpu"), t_start=time.perf_counter())
    start, end = snaps[traffic["join_steps"] - 1], snaps[-1]
    assert len(snaps) == traffic["join_steps"] + len(obs["chunks"])
    assert obs["nodes"] > 0
    assert end["nodes_expanded"] - start["nodes_expanded"] == obs["nodes"]
    assert (end["lane_supersteps"] - start["lane_supersteps"]
            == sum(c["ran"] * c["lanes"] for c in obs["chunks"]))
    assert (end["busy_lane_supersteps"] - start["busy_lane_supersteps"]
            == sum(c["busy"] for c in obs["chunks"]))
    assert end["lane_supersteps"] == end["supersteps"] * traffic["lanes"]


def test_counters_survive_a_checkpoint(tmp_path):
    from repro_torch.api import SolveConfig, SolveService

    cfg = SolveConfig(service_lanes=2, num_workers=4, steps_per_round=2, chunk_rounds=2)
    svc = SolveService("vertex_cover", cfg, device="cpu")
    for g in _graphs():
        svc.submit(g)
    for _ in range(3):
        svc.step()
    before = svc.stats()
    assert before["busy_lane_supersteps"] <= before["lane_supersteps"]
    back = SolveService.restore(svc.checkpoint(str(tmp_path)), device="cpu")
    after = back.stats()
    for k in ("nodes_expanded", "lane_supersteps", "busy_lane_supersteps", "supersteps"):
        assert after[k] == before[k], k


def test_profile_gives_device_time_and_gaps_to_the_innermost_range(tmp_path):
    from repro_torch.launch.profile import gap_split, range_split

    def launch(ts, corr):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    ev = [
        {"cat": "user_annotation", "name": "plane.superstep", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "explore.pop", "ts": 10, "dur": 10},
        {"cat": "user_annotation", "name": "explore.push", "ts": 30, "dur": 10},
        {"cat": "user_annotation", "name": "center.match", "ts": 60, "dur": 10},
        launch(12, 1), launch(25, 2), launch(33, 3), launch(65, 4), launch(150, 5),
        kernel(100, 1000, 1), kernel(1100, 2000, 2), kernel(3200, 3000, 3),
        kernel(6200, 500, 4), kernel(6800, 250, 5),
    ]
    ev += [{"cat": "cpu_op", "name": "aten::x", "ts": 3100, "dur": 1}]
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": ev}))
    # the launch at 25 lies in the superstep after its pop closed
    assert range_split(trace) == {"explore.pop": 1.0, "plane.superstep": 2.0,
                                  "explore.push": 3.0, "center.match": 0.5, "other": 0.25}
    assert range_split(trace, ("explore.pop",)) == {"explore.pop": 1.0, "other": 5.75}
    # gaps at 3100-3200 (middle 3150) and 6700-6800 (6750): no range open
    ev += [{"cat": "user_annotation", "name": "plane.done_read", "ts": 3000, "dur": 500}]
    trace.write_text(json.dumps({"traceEvents": ev}))
    assert gap_split(trace) == {"plane.done_read": 0.1, "other": 0.1}


@pytest.fixture
def card():
    """The card, decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stream_time_on_the_card(card):
    """On a CUDA device a span's stream time comes from its two events: the
    device time of the work enqueued inside it."""
    a = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize(card)
    with telemetry.recording():
        with telemetry.span("outer", card):
            with telemetry.span("matmul", card, n=4096):
                for _ in range(8):
                    a = a @ a / 4096
    inner, outer = telemetry.spans()
    assert (inner.name, inner.parent, inner.ids, outer.name) == ("matmul", "outer",
                                                                   {"n": 4096}, "outer")
    assert inner.events is not None and 0 < inner.stream_ms <= outer.stream_ms
    # 8 products of 2·4096³ FLOP take well over the host's enqueue time
    assert inner.stream_ms > inner.host_ms
