"""BENCHMARK.json keeps to its contract, every piece of a cell is found by
name, and a new cell and metric are added as files alone."""

import json
import re
import shutil

import pytest

from conftest import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert len({(x["config"], x["traffic"]) for x in b["workloads"]}) == len(b["workloads"])


def test_every_piece_is_found_by_name():
    b = _bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    for w in b["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["config"] in {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    traffic = json.loads((ROOT / "perfbench/traffic/vc-gnp600-lanes32.json").read_text())
    (tmp_path / "perfbench/traffic/vc-gnp600-lanes8.json").write_text(
        json.dumps(dict(traffic, lanes=8, clients=8)))
    (tmp_path / "perfbench/metrics/answers_per_window.py").write_text(
        "def read(obs):\n    return len(obs['answers'])\n")
    b["workloads"].append({"name": "vc-gnp600-lanes8", "config": "vc-gnp600",
                           "traffic": "vc-gnp600-lanes8", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "answers_per_window", "unit": "answers", "better": "higher",
                           "source": "program_counter", "layer": "service",
                           "moves": "nodes_per_s", "workloads": ["vc-gnp600-lanes8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    from perfbench import bench

    wl, config, tr, e2e, per_layer = bench.load_cell("vc-gnp600-lanes8", root=tmp_path)
    assert tr["lanes"] == 8 and config["problem"] == "vertex_cover"
    assert [m["name"] for m in per_layer if m["name"] == "answers_per_window"]
    mod = bench.load_module(tmp_path / "perfbench/metrics/answers_per_window.py")
    assert mod.read({"answers": [1, 2, 3]}) == 3


MIS = '''"""Maximum independent set: max clique on the complement."""
import numpy as np

from perfbench.reference import bits
from perfbench.reference.problems import max_clique

expand = max_clique.expand


def adjacency(dense):
    return ~dense & ~np.eye(len(dense), dtype=bool)


def infeasible(dense, size, words):
    s = bits.solution(words, dense.shape[0], size)
    return s is None or bool(dense[np.ix_(s, s)].any())


def optimum(dense):
    return max_clique.optimum(adjacency(dense))
'''


def test_a_new_problem_needs_only_new_files(tmp_path):
    """A configuration of a problem no cell has yet (the registry's ``mis``),
    its plain reference, traffic and cell, added as files to a copy of the
    harness, run and judged there."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    b = _bench()
    config = json.loads((ROOT / "perfbench/configs/vc-gnp600.json").read_text())
    config.update(name="mis-gnp600", problem="mis",
                  kernel_entry="repro_torch.problems.max_clique:clique_expand",
                  guarantees=dict(config["guarantees"], optimum_checked=True))
    (tmp_path / "perfbench/configs/mis-gnp600.json").write_text(json.dumps(config))
    (tmp_path / "perfbench/reference/problems/mis.py").write_text(MIS)
    traffic = json.loads((ROOT / "perfbench/traffic/vc-gnp600-lanes32.json").read_text())
    (tmp_path / "perfbench/traffic/mis-gnp600-lanes32.json").write_text(json.dumps(traffic))
    b["configs"].append({"name": "mis-gnp600", "source": "https://arxiv.org/abs/2305.09117",
                         "file": "perfbench/configs/mis-gnp600.json", "reduced": [],
                         "why": "a test configuration"})
    b["workloads"].append({"name": "mis-gnp600-lanes32", "config": "mis-gnp600",
                           "traffic": "mis-gnp600-lanes32", "chips": 1, "why": "a test cell"})
    for m in b["per_layer"]:
        if m["moves"] == "nodes_per_s" and m["name"] != "vc_expand.roofline":
            m["workloads"].append("mis-gnp600-lanes32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    line, checks = run_tiny("mis-gnp600-lanes32", trace=True, n=24, root=tmp_path)
    out = json.loads(line)
    assert out["correct"] is True and out["attempted"] > 0
    assert set(checks) >= {"answers_infeasible", "answers_not_optimal", "kernel_rows_differ",
                           "superstep_leaves_differ", "samples_missing"}
    assert "superstep_ms" in out["metrics"]
    from perfbench import control

    with control.plant("kernel", config):  # the new reference judges the kernel's rows
        line, checks = run_tiny("mis-gnp600-lanes32", n=24, root=tmp_path)
    assert json.loads(line)["correct"] is False and checks["kernel_rows_differ"][0] > 0
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    line, checks = run_tiny("vc-gnp600-lanes32", trace=trace)
    out = json.loads(line)
    keys = list(out)
    assert keys[-1] == "checks" and {"correct", "attempted", "failed", "metrics",
                                     "device"} <= set(keys)
    assert out["correct"] is True and out["attempted"] >= out["failed"] >= 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = set(out["metrics"])
    if trace:
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "superstep_ms" in names and "nodes_per_s" not in names
    else:
        assert {"nodes_per_s", "setup_s"} <= names
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert {k: (v["value"], v["limit"]) for k, v in out["checks"].items()} == checks
