"""Both legs of ``benchmarks/chaos_smoke.py`` through the port on the CPU.

``chaos_smoke``'s service leg (a saturated 3-lane spilled service under
crashes, a stall, payload corruption and a checkpoint write error) and its
solo leg (a checkpointed spilled solve that crashes and recovers through
checkpoint I/O errors), at both of that file's sizes, with its two fault
plans (the helpers of ``tests/test_torch_chaos_fixture.py``).  Every answer
equals the JAX package's under the same plan and the port's own fault-free
run, field for field; both injector reports equal JAX's and end with
nothing pending; and the totals equal the exact pins of
``benchmarks/baseline.json`` (10 injected, 10 recovered, 7 retries, 2 lanes
quarantined; by kind 2/1/2/2/3).  The wall ratio is not gated.
"""

import json
import pathlib

import pytest

from repro.api import PlaneCache as JaxCache
from repro_torch.api import PlaneCache
from repro_torch.faults import FAULT_KINDS

from tests.test_torch_chaos_fixture import jax_pkg, legs, port_pkg, run_leg

BASELINE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "baseline.json"
_JCACHE = JaxCache()
_CACHE = PlaneCache()


def _lookup(d: dict, path: str):
    for part in path.split("."):
        d = d[part]
    return d


def _solve_fields(results: list) -> list:
    return [{k: v for k, v in r.items() if k != "ledger"} for r in results]


@pytest.mark.parametrize("n0,count", [(40, 6), (36, 5)])
def test_chaos_legs_equal_jax_and_the_pins(n0, count):
    out, totals = {}, {"injected": dict.fromkeys(FAULT_KINDS, 0),
                       "recovered": dict.fromkeys(FAULT_KINDS, 0), "retries": 0}
    for name, leg in legs(n0, count).items():
        got = run_leg(port_pkg(), name, leg, cache=_CACHE)
        want = run_leg(jax_pkg(), name, leg, cache=_JCACHE)
        clean = run_leg(port_pkg(), name, leg, faults=False, cache=_CACHE)
        assert got == want, name
        assert _solve_fields(got["results"]) == _solve_fields(clean["results"]), name
        assert all(r["overflow_count"] == 0 for r in got["results"])
        rep = got["report"]
        assert rep["pending"] == 0 and rep["injected"] == rep["recovered"], name
        for key in ("injected", "recovered"):
            for kind in FAULT_KINDS:
                totals[key][kind] += rep[key][kind]
        totals["retries"] += rep["retries"]
        out[name] = got
    # chaos_smoke.run's output, read by the baseline's checks
    reading = {
        "faults_injected": sum(totals["injected"].values()),
        "faults_recovered": sum(totals["recovered"].values()),
        "retries": totals["retries"],
        "lanes_quarantined": out["service"]["stats"]["lanes_quarantined"],
        "injected_by_kind": totals["injected"],
        "all_kinds_covered": all(v >= 1 for v in totals["injected"].values()),
        "bit_identical": True,  # asserted above
        "no_drop": True,  # asserted above
    }
    checks = json.loads(BASELINE.read_text())["benchmarks"]["chaos_smoke"]["checks"]
    gated = [c for c in checks if c["path"] != "wall_ratio"]
    assert len(gated) == len(checks) - 1 == 12
    for c in gated:
        assert _lookup(reading, c["path"]) == c["eq"], c
    assert out["service"]["stats"]["lanes_shed"] == 0
    # the service's ledger: each ticket's slice sums to the service's
    tickets = [r["ledger"] for r in out["service"]["results"]]
    stats = out["service"]["stats"]
    assert sum(t["lanes_quarantined"] for t in tickets) == stats["lanes_quarantined"]
    injected = out["service"]["report"]["injected"]
    assert sum(t["faults_injected"] for t in tickets) == injected["crash"] + injected["stall"]
