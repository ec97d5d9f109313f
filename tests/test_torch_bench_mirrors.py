"""The remaining benchmark mirrors against their ``benchmarks/`` namesakes.

Each mirror runs on the port on the CPU here, at its smoke size, and what it
computes deterministically equals the JAX package's: the explore A/B's
searches, ``engine_throughput``'s budget and transfer rows,
``kernel_bench``'s rows, ``batch_throughput``'s and ``serve_load``'s
answers, ``session_warm``'s plane count, the spill counters, the chaos legs
and pins, and ``resume_smoke``'s workloads and their solves.  Wall-clock
readings are recorded, never compared.  ``resume_smoke``'s SIGKILL cycles
and ``serve_load``'s Poisson leg run on the card (``chip_smoke.py`` phase
16).  ``check_regression`` passes on a recorded run and fails on a violated
pin and on a missing entry.
"""

import json

import numpy as np
import pytest

from benchmarks import engine_throughput as jax_engine
from benchmarks import explore_throughput as jax_explore
from benchmarks import kernel_bench as jax_kernel
from benchmarks import resume_smoke as jax_resume
from repro.api import PlaneCache as JaxCache
from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro.problems.sequential import solve_sequential_max_clique as jax_max_clique
from repro_torch.bench import (
    batch_throughput,
    chaos_smoke,
    check_regression,
    engine_throughput,
    explore_throughput,
    kernel_bench,
    resume_smoke,
    serve_load,
    session_warm,
    spill_throughput,
)
from repro_torch.bench import run as bench_run
from repro_torch.graphs.generators import erdos_renyi

CPU = "cpu"


def _key(r) -> tuple:
    sol = None if r.best_sol is None else tuple(np.asarray(r.best_sol, np.uint32).tolist())
    return r.best_size, sol, r.rounds, r.nodes_expanded


@pytest.mark.parametrize("problem", ["max_clique", "vertex_cover"])
def test_explore_throughput_ab_equals_jax_search(problem):
    """Both routes bit-identical (asserted inside ``ab``), and the search
    equal to the JAX package's fused plane at the smoke's shape."""
    kw = explore_throughput.shapes(smoke=True)[problem]
    common = dict(workers=kw["workers"], spr=kw["spr"], lanes=kw["lanes"], repeats=1)
    _, _, ours = explore_throughput.ab(
        problem, [erdos_renyi(kw["n"], kw["p"], s) for s in kw["seeds"]],
        device=CPU, **common)
    _, theirs = jax_explore._throughput(
        problem, [jax_erdos_renyi(kw["n"], kw["p"], s) for s in kw["seeds"]], "fused",
        **common)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]


def test_engine_throughput_budget_rows_equal_jax():
    assert engine_throughput.budget_rows(CPU) == jax_engine.budget_rows()


def test_engine_throughput_transfer_rows_equal_jax():
    assert engine_throughput.transfer_ab(CPU) == jax_engine.transfer_ab()


def test_engine_throughput_chunked_rows_shape():
    rows = engine_throughput.chunked_ab(R=8, device=CPU)
    assert [r["mode"] for r in rows] == [
        "coordination (steps_per_round=0)", "compute round (steps_per_round=1)"]
    assert all(r["workers"] == 64 and r["chunk_rounds"] == 32 and r["speedup"] > 0
               for r in rows)


def test_kernel_bench_rows_equal_jax():
    """The same rows; on the CPU no time is taken (it would not be the card's)."""
    ours = kernel_bench.run(csv=False, device=CPU)
    assert ours == jax_kernel.run(csv=False)
    assert all("ms" not in r for r in ours)


def test_batch_throughput_answers_equal_jax():
    out = batch_throughput.run(smoke=True, device=CPU)
    assert [r["B"] for r in out["rows"]] == [1, 4, 16]
    graphs = [jax_erdos_renyi(out["n"], out["p"], s) for s in range(16)]
    jb = JaxSession(config=JaxConfig(num_workers=out["workers"],
                                     steps_per_round=out["steps_per_round"])).solve_many(graphs)
    assert out["rows"][-1]["best"] == [r.best_size for r in jb.results]
    assert out["rows"][-1]["rounds"] == [r.rounds for r in jb.results]
    assert out["min_speedup_b16"] == 2.0  # the namesake's bar, recorded


def test_session_warm_builds_one_plane():
    out = session_warm.run(smoke=True, device=CPU)
    assert out["plane_traces"] == 1
    assert (out["cache"]["misses"], out["cache"]["hits"], out["cache"]["planes"]) == (1, 2, 1)


def test_spill_throughput_counters_equal_jax():
    out = spill_throughput.run(smoke=True, device=CPU)
    g = jax_erdos_renyi(out["n"], out["p"], 0)
    base = JaxConfig(num_workers=4, steps_per_round=2, chunk_rounds=2,
                     capacity=out["capacity"])
    cache = JaxCache()

    def solve(cfg):
        return JaxSession("vertex_cover", config=cfg, cache=cache).solve(g)

    unsat = solve(base.replace(capacity=None))
    starved = solve(base)
    spilled = solve(base.replace(frontier_spill=True))
    assert out["best"] == unsat.best_size
    assert out["starved_overflow_count"] == starved.stats.overflow_count > 0
    assert out["starved_best"] == starved.best_size
    assert (out["spilled_tasks"], out["readmitted_tasks"], out["cold_bytes_peak"]) == (
        spilled.stats.spilled_tasks, spilled.stats.readmitted_tasks,
        spilled.stats.cold_bytes_peak)
    assert out["no_drop"] and out["optimum_matches"]


def test_serve_load_throughput_answers_equal_jax():
    """The deterministic part: both admission policies give every request
    the JAX package's optimum and drop nothing."""
    requests, n_easy, n_hard = serve_load.sizes(smoke=True)
    gs = serve_load.trace(requests, n_easy, n_hard, seed=100)
    tp = serve_load.throughput(gs, serve_load.config(), CPU)
    want = [jax_max_clique(jax_erdos_renyi(g.n, 0.5, seed=100 + i))[0]
            for i, g in enumerate(gs)]
    assert [r.best_size for r in tp["results"]] == want
    assert 0 < tp["occupancy"] <= 1


def test_chaos_smoke_legs_are_the_fixtures_and_meet_the_pins():
    from tests.test_torch_chaos_fixture import legs as fixture_legs

    for smoke, (n0, count) in ((True, (36, 5)), (False, (40, 6))):
        ours, theirs = chaos_smoke.legs(smoke), fixture_legs(n0, count)
        for name, leg in theirs.items():
            assert {k: ours[name][k] for k in ("solve_kw", "plan")} == {
                k: leg[k] for k in ("solve_kw", "plan")}
            assert ours[name].get("serve_kw") == leg.get("serve_kw")
            assert [(g.n, g.adj.tobytes()) for g in ours[name]["graphs"]] == [
                (s["n"], erdos_renyi(s["n"], s["p"], s["seed"]).adj.tobytes())
                for s in leg["graphs"]]
    out = chaos_smoke.run(smoke=True, device=CPU)
    baseline = json.loads(check_regression.BASELINE.read_text())
    gate = {"benchmarks": {"chaos_smoke": baseline["benchmarks"]["chaos_smoke"]}}
    assert check_regression.check(gate, {"benchmarks": {"chaos_smoke": out}}) == []


@pytest.mark.parametrize("variant", ["plain", "spill", "deep"])
def test_resume_smoke_workloads_equal_jax(variant):
    """The workload each child and the parent build, and its uninterrupted
    solve (the baseline every resume is held to), equal the namesake's."""
    kw = dict(spill=variant == "spill", deep=variant == "deep")
    g, cfg = resume_smoke.workload(True, **kw)
    jg, jcfg = jax_resume._workload(True, **kw)
    assert (g.n, g.adj.tobytes()) == (jg.n, np.asarray(jg.adj).tobytes())
    assert cfg.to_dict() == jcfg.to_dict()
    from repro_torch.api import SolverSession

    ours = SolverSession(config=cfg, device=CPU).solve(g)
    theirs = JaxSession(config=jcfg).solve(jg)
    assert _key(ours) == _key(theirs)
    assert ours.stats.spilled_tasks == theirs.stats.spilled_tasks
    if variant == "spill":
        assert ours.stats.spilled_tasks > 0


def test_check_regression_gates_a_recorded_run(tmp_path, capsys):
    baseline = json.loads(check_regression.BASELINE.read_text())
    bench = tmp_path / "BENCH.json"
    # a run that records every reading the baseline names, at its pins
    recorded = {}
    for name, spec in baseline["benchmarks"].items():
        entry = {}
        for rule in spec["checks"]:
            value = rule.get("eq", rule.get("min", rule.get("max")))
            cur, parts = entry, rule["path"].split(".")
            for i, part in enumerate(parts[:-1]):
                nxt = [] if parts[i + 1].isdigit() else {}
                if isinstance(cur, list):
                    while len(cur) <= int(part):
                        cur.append(type(nxt)())
                    cur = cur[int(part)]
                else:
                    cur = cur.setdefault(part, nxt)
            if isinstance(cur, list):
                while len(cur) <= int(parts[-1]):
                    cur.append(None)
                cur[int(parts[-1])] = value
            else:
                cur[parts[-1]] = value
        recorded[name] = entry
    run = {"smoke": True, "benchmarks": recorded}
    assert check_regression.check(baseline, run) == []
    bench.write_text(json.dumps(run))
    check_regression.main(["--bench", str(bench)])
    assert "within baseline" in capsys.readouterr().out
    # floors and ceilings are not applied: a wall ratio far over its ceiling passes
    recorded["spill_throughput"]["wall_ratio"] = 99.0
    assert check_regression.check(baseline, run) == []
    # a violated pin fails
    recorded["chaos_smoke"]["retries"] = 6
    assert check_regression.check(baseline, run) == ["chaos_smoke.retries: 6 != pinned 7"]
    recorded["chaos_smoke"]["retries"] = 7
    # a missing entry fails, and so does a missing reading
    del recorded["serve_load"]
    del recorded["session_warm"]["warm_speedup"]
    assert check_regression.check(baseline, run) == [
        "session_warm.warm_speedup: missing from the run",
        "serve_load: missing from the smoke run",
    ]
    bench.write_text(json.dumps(run))
    with pytest.raises(SystemExit) as e:
        check_regression.main(["--bench", str(bench)])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        check_regression.main(["--bench", str(tmp_path / "absent.json")])
    assert e.value.code == 2


def test_run_lists_every_mirror_and_the_namesakes_smoke_set():
    from benchmarks import run as jax_run

    assert sorted(bench_run.ALL) == sorted(jax_run.ALL)
    assert bench_run.SMOKE_DEFAULT == jax_run.SMOKE_DEFAULT
    baseline = json.loads(check_regression.BASELINE.read_text())
    assert set(baseline["benchmarks"]) <= set(bench_run.SMOKE_DEFAULT)
