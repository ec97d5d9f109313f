"""Self-healing gate: a seeded fault schedule costs nothing but time.

The port's mirror of ``benchmarks/chaos_smoke.py``, on ``device``.  Its two
legs are the ones ``src/repro_torch/data/golden_chaos.json`` records (the
JAX package's run of that file's legs; ``tests/test_torch_chaos.py`` and
``chip_smoke.py`` phase 14 run them too): their configs and fault plans are
read from there, so they are not written out a second time.

* **service leg** — a saturated 3-lane spilled ``SolveService`` with
  checkpoints, under lane crashes, a stall window, corrupt transfer and
  cold-tier payloads and a checkpoint write error;
* **solo leg** — a checkpointed spilled ``solve`` that crashes and recovers
  through a checkpoint read error and a later write error.

Asserted, as in the namesake: every answer bit-identical to the fault-free
run's, nothing dropped, every ticket completes, all five kinds fired and
every fault recovered, nothing pending; at the full size the answers and
both injector reports also equal the JAX record.  The namesake's wall gate
(faulted within ``MAX_WALL_RATIO`` of fault-free) was set on a CPU; here the
ratio is recorded, not asserted.
"""

from __future__ import annotations

import json
import tempfile
import time
import warnings
from pathlib import Path

from repro_torch.api import PlaneCache, SolveConfig, SolverSession
from repro_torch.faults import FAULT_KINDS, FaultInjector, FaultPlan
from repro_torch.graphs.generators import erdos_renyi

GOLDEN = Path(__file__).resolve().parents[1] / "data" / "golden_chaos.json"
# the namesake's bar (recorded, not asserted: see the module docstring)
MAX_WALL_RATIO = 1.5


def legs(smoke: bool) -> dict:
    """Both legs at the namesake's size (``smoke``: n0 36, 5 requests; else
    n0 40, 6, the golden's own), with the golden's configs and plans."""
    golden = json.loads(GOLDEN.read_text())
    n0, count = (36, 5) if smoke else (40, 6)
    out = {name: {k: leg[k] for k in ("solve_kw", "serve_kw", "plan") if k in leg}
           for name, leg in golden.items()}
    out["service"]["graphs"] = [erdos_renyi(n0 + i, 0.28, seed=i) for i in range(count)]
    out["solo"]["graphs"] = [erdos_renyi(n0 + 4, 0.3, seed=11)]
    return out


def run_leg(name: str, leg: dict, cache, device, faults: bool = True):
    """One leg with its plan's injector (or fault-free); returns (results in
    submission order, the service or None, the injector or None)."""
    inj = FaultInjector(FaultPlan.from_dict(leg["plan"])) if faults else None
    session = SolverSession("vertex_cover", config=SolveConfig(**leg["solve_kw"]),
                            cache=cache, device=device)
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the store's retry warnings
        if name == "service":
            svc = session.serve(injector=inj, checkpoint_dir=d, **leg["serve_kw"])
            tickets = [svc.submit(g) for g in leg["graphs"]]
            svc.drain()
            return [svc.result(t) for t in tickets], svc, inj
        extra = {"injector": inj} if inj is not None else {}
        return [session.solve(leg["graphs"][0], checkpoint_dir=d, **extra)], None, inj


def _answer(r) -> tuple:
    return int(r.best_size), tuple(int(w) for w in r.best_sol)


def run(smoke: bool = False, device="cuda") -> dict:
    cache = PlaneCache()
    cases = legs(smoke)

    def both(faults):
        return {name: run_leg(name, leg, cache, device, faults) for name, leg in cases.items()}

    # warm every path both runs take (the chaos trajectory is chunk-clocked,
    # so the warm pass is the timed one's twin)
    both(False), both(True)
    t0 = time.perf_counter()
    clean = both(False)
    ref_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    chaos = both(True)
    chaos_wall = time.perf_counter() - t0

    for name in cases:
        want, got = clean[name][0], chaos[name][0]
        assert len(got) == len(want), f"{name}: tickets were lost"
        assert [_answer(r) for r in got] == [_answer(r) for r in want], (
            f"{name}: answers under faults differ from the fault-free run")
        assert all(r.stats.overflow_count == 0 for r in got), f"{name} dropped tasks"
    injs = {name: chaos[name][2] for name in cases}
    injected = {k: sum(i.injected[k] for i in injs.values()) for k in FAULT_KINDS}
    recovered = {k: sum(i.recovered[k] for i in injs.values()) for k in FAULT_KINDS}
    all_kinds = all(injected[k] >= 1 for k in FAULT_KINDS)
    assert all_kinds, f"fault kinds not covered: {injected}"
    assert injected == recovered, f"unrecovered faults: {injected} vs {recovered}"
    assert all(i.report()["pending"] == 0 for i in injs.values()), "faults never fired"
    if not smoke:  # the golden's own size: the JAX package's record
        golden = json.loads(GOLDEN.read_text())
        for name in cases:
            assert injs[name].report() == golden[name]["report"], name
            want = [(r["best_size"], tuple(r["best_sol"]), r["rounds"], r["nodes_expanded"])
                    for r in golden[name]["results"]]
            got = [(*_answer(r), int(r.rounds), int(r.nodes_expanded))
                   for r in chaos[name][0]]
            assert got == want, f"{name} leg != the JAX record"

    wall_ratio = chaos_wall / max(ref_wall, 1e-9)
    s = chaos["service"][1].stats()
    out = dict(
        instances=len(cases["service"]["graphs"]) + 1,
        faults_injected=sum(injected.values()),
        faults_recovered=sum(recovered.values()),
        retries=sum(i.retries for i in injs.values()),
        lanes_quarantined=int(s["lanes_quarantined"]),
        injected_by_kind={k: int(v) for k, v in injected.items()},
        all_kinds_covered=bool(all_kinds),
        bit_identical=True,  # asserted above, recorded for the baseline pin
        no_drop=True,
        ref_wall_s=round(ref_wall, 3),
        chaos_wall_s=round(chaos_wall, 3),
        wall_ratio=round(wall_ratio, 2),
        max_wall_ratio=MAX_WALL_RATIO,
    )
    print(
        f"chaos gate: {out['faults_injected']} faults over {out['instances']} "
        f"instances, all recovered ({out['retries']} retries, "
        f"{out['lanes_quarantined']} lanes quarantined), bit-identical at "
        f"{out['wall_ratio']}x the fault-free wall"
    )
    return out


if __name__ == "__main__":
    run()
