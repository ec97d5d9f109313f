"""The port's benchmark mirrors (``repro_torch.bench``) against ``benchmarks/``.

Each mirror runs what its ``benchmarks/`` namesake runs, on the port, on the
CPU here: its rows must equal the JAX benchmark's rows exactly (the
simulators' ticks, bytes and failed requests, the SPMD donation rows, the
codecs' bytes, the balancer's makespans), and ``repro_torch.bench.run
--smoke`` (the namesake's smoke set) must meet the exact pins of
``benchmarks/baseline.json``.  Wall-clock columns are left out of every
comparison.  The other mirrors are ``tests/test_torch_bench_mirrors.py``.
"""

import json

import pytest

from benchmarks import balancer_bench as jax_balancer
from benchmarks import clique_smoke as jax_clique
from benchmarks import encoding_bytes as jax_encoding
from benchmarks import protocol_stats as jax_protocol
from benchmarks import speedup as jax_speedup
from repro.graphs import generators as jax_gen
from repro_torch.bench import balancer_bench, clique_smoke, encoding_bytes, protocol_stats
from repro_torch.bench import run as bench_run
from repro_torch.bench import speedup
from repro_torch.graphs import generators as gen

WALL_KEYS = ("wall_s", "inst_per_s", "elapsed_s")


def _no_wall(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in WALL_KEYS}


def test_protocol_stats_rows_equal_jax():
    rows = protocol_stats.run(csv=False)
    assert rows == jax_protocol.run(csv=False)
    assert all(r["failed_requests"] == 0 for r in rows)


def test_encoding_bytes_rows_equal_jax():
    assert encoding_bytes.run(csv=False) == jax_encoding.run(csv=False)


def test_balancer_bench_rows_equal_jax():
    assert balancer_bench.run(csv=False) == jax_balancer.run(csv=False)


@pytest.mark.parametrize("workers", [2, 4, 8, 16, 32])
def test_speedup_hard_rows_equal_jax(workers):
    """``gnp80_p2_hard``: both simulators under both codecs at P workers."""
    ours = speedup.rows("gnp80_p2_hard", gen.erdos_renyi(80, 0.2, 0), [workers])
    theirs = jax_speedup.rows("gnp80_p2_hard", jax_gen.erdos_renyi(80, 0.2, 0), [workers])
    assert ours == theirs
    assert [r["codec"] for r in ours] == ["optimized", "basic"]
    assert all(r["semi_failed"] == 0 for r in ours)


def test_speedup_easy_rows_equal_jax():
    ours = speedup.rows("phat_48_easy", gen.p_hat_like(48, 0.45, 1), [2, 8])
    theirs = jax_speedup.rows("phat_48_easy", jax_gen.p_hat_like(48, 0.45, 1), [2, 8])
    assert ours == theirs


def test_speedup_donation_rows_equal_jax():
    """The SPMD rows: the port's engine (here on the CPU) against JAX's."""
    ours = speedup.donation_rows("gnp64_skewed", gen.erdos_renyi(64, 0.22, 3), [8, 16],
                                 device="cpu")
    theirs = jax_speedup.donation_rows("gnp64_skewed", jax_gen.erdos_renyi(64, 0.22, 3),
                                       [8, 16])
    assert ours == theirs


def test_clique_smoke_equals_jax():
    ours = clique_smoke.run(smoke=True, device="cpu")
    theirs = jax_clique.run(smoke=True)
    assert _no_wall(ours) == _no_wall(theirs)
    assert ours["sizes"] == [4, 6, 4, 4]


def test_run_smoke_meets_the_baseline_pins(tmp_path, monkeypatch, capsys):
    """The namesake's whole smoke set, gated by ``check_regression``: every
    benchmark of the baseline present, every exact pin met."""
    from repro_torch.bench import check_regression

    monkeypatch.setattr(bench_run, "OUT", tmp_path / "BENCH.json")
    bench_run.main(["--smoke", "--device", "cpu"])
    out = json.loads((tmp_path / "BENCH.json").read_text())
    assert sorted(out["benchmarks"]) == sorted(bench_run.SMOKE_DEFAULT)
    assert "exact pins of baseline.json met" in capsys.readouterr().out
    check_regression.main(["--bench", str(tmp_path / "BENCH.json")])
    assert "within baseline" in capsys.readouterr().out
    # the pins come from the committed baseline, which holds wall floors
    # that the port does not apply
    baseline = json.loads(bench_run.BASELINE.read_text())
    assert any("min" in r for r in baseline["benchmarks"]["session_warm"]["checks"])


def test_check_pins_reports_each_violation():
    baseline = json.loads(bench_run.BASELINE.read_text())
    rows = encoding_bytes.run(csv=False)
    assert bench_run.check_pins(baseline, {"encoding_bytes": rows}) == []
    bad = bench_run.check_pins(baseline, {"clique_smoke": {"sizes": [4, 6, 4, 5]},
                                          "encoding_bytes": {"rows": []}})
    assert any("clique_smoke.sizes" in p for p in bad)
    assert any("encoding_bytes.rows.0.n: missing" in p for p in bad)


def test_run_rejects_an_unknown_benchmark():
    with pytest.raises(SystemExit) as e:
        bench_run.main(["roofline_report", "--device", "cpu"])
    assert e.value.code == 2
