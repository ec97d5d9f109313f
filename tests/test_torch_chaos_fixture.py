"""The JAX-made record of both chaos legs, for the port to reproduce on the card.

The two legs are ``benchmarks/chaos_smoke.py``'s, as that file configures
them at its full size: a 3-lane service of 6 saturated vertex-cover
requests (``erdos_renyi(40 + i, 0.28, i)``, 4 workers, capacity 12, spill,
a checkpoint every 3 steps, ``lane_stall_chunks`` 2) under lane crashes, a
stall window, corrupted transfer and cold-tier payloads and a checkpoint
write error, and a checkpointed solo solve (``erdos_renyi(44, 0.3, 11)``,
capacity 16, spill, a checkpoint every 2 chunks) that crashes and recovers
through a checkpoint read error and a later write error.  Run as a script,
it solves both with the JAX package and writes
``src/repro_torch/data/golden_chaos.json``: each leg's graphs, config,
fault plan, results field for field (each ticket's ``ServiceStats`` ledger
included), its injector's report and the service's ledger.

  PYTHONPATH=src python tests/test_torch_chaos_fixture.py

``chip_smoke.py`` phase 14 reads it from the checkout.  Run as a test, it
checks that the JAX package still writes the same fixture and that the port
reproduces it on the CPU.  ``tests/test_torch_chaos.py`` runs the legs
through both packages at both of ``chaos_smoke``'s sizes with the helpers
here.
"""

import json
import pathlib
import sys
import tempfile
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "src" / "repro_torch" / "data"
GOLDEN = DATA / "golden_chaos.json"
# the service's self-healing ledger, as stats() reports it
LEDGER = ("lanes_quarantined", "lanes_shed", "faults_injected", "faults_recovered", "retries")
TICKET_LEDGER = ("faults_injected", "faults_recovered", "lanes_quarantined", "retries")


def legs(n0: int = 40, count: int = 6) -> dict:
    """``chaos_smoke.run``'s two legs (``smoke=True`` is n0 36, count 5)."""
    from benchmarks.chaos_smoke import _service_events, _solo_events
    from repro.faults import FaultPlan

    base = dict(num_workers=4, steps_per_round=2, chunk_rounds=2, frontier_spill=True)
    return {
        "service": {
            "graphs": [{"generator": "erdos_renyi", "n": n0 + i, "p": 0.28, "seed": i}
                       for i in range(count)],
            "solve_kw": {**base, "service_lanes": 3, "capacity": 12},
            "serve_kw": {"lane_stall_chunks": 2, "checkpoint_every": 3},
            "plan": FaultPlan(seed=0, events=_service_events()).to_dict(),
        },
        "solo": {
            "graphs": [{"generator": "erdos_renyi", "n": n0 + 4, "p": 0.3, "seed": 11}],
            "solve_kw": {**base, "capacity": 16, "checkpoint_every": 2},
            "plan": FaultPlan(seed=1, events=_solo_events()).to_dict(),
        },
    }


def record(r) -> dict:
    s = r.stats
    out = {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
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
    if s.service is not None:
        out["ledger"] = {k: int(getattr(s.service, k)) for k in TICKET_LEDGER}
    return out


def jax_pkg():
    from repro import api, faults
    from repro.graphs import generators

    return api, faults, generators, {}


def port_pkg():
    from repro_torch import api, faults
    from repro_torch.graphs import generators

    return api, faults, generators, {"device": "cpu"}


def run_leg(pkg, name: str, leg: dict, *, faults: bool = True, cache=None) -> dict:
    """One leg through one package (``jax_pkg()`` or ``port_pkg()``), with
    its plan's injector or fault-free; returns its results, the injector's
    report and (service) the ledger of ``stats()``."""
    api, faults_mod, gen, kw = pkg
    inj = None
    if faults:
        inj = faults_mod.FaultInjector(faults_mod.FaultPlan.from_dict(leg["plan"]))
    session = api.SolverSession("vertex_cover", config=api.SolveConfig(**leg["solve_kw"]),
                                cache=cache, **kw)
    graphs = [getattr(gen, g["generator"])(**{k: v for k, v in g.items() if k != "generator"})
              for g in leg["graphs"]]
    out = {}
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the store's retry warnings
        if name == "service":
            svc = session.serve(injector=inj, checkpoint_dir=d, **leg["serve_kw"])
            tickets = [svc.submit(g) for g in graphs]
            svc.drain()
            out["results"] = [record(svc.result(t)) for t in tickets]
            st = svc.stats()
            out["stats"] = {k: int(st[k]) for k in LEDGER}
        else:
            extra = {"injector": inj} if inj is not None else {}
            out["results"] = [record(session.solve(graphs[0], checkpoint_dir=d, **extra))]
    if inj is not None:
        out["report"] = inj.report()
    return out


def jax_golden() -> dict:
    from repro.api import PlaneCache

    cache = PlaneCache()
    return {name: {**leg, **run_leg(jax_pkg(), name, leg, cache=cache)}
            for name, leg in legs().items()}


def test_jax_still_writes_the_fixture():
    assert json.loads(GOLDEN.read_text()) == json.loads(json.dumps(jax_golden()))


def test_port_reproduces_the_fixture_on_the_cpu():
    from repro_torch.api import PlaneCache

    cache = PlaneCache()
    for name, case in json.loads(GOLDEN.read_text()).items():
        leg = {k: case[k] for k in ("graphs", "solve_kw", "serve_kw", "plan") if k in case}
        got = json.loads(json.dumps(run_leg(port_pkg(), name, leg, cache=cache)))
        want = {k: case[k] for k in ("results", "report", "stats") if k in case}
        assert got == want, name
        assert got["report"]["pending"] == 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))  # benchmarks/ (pytest puts the root there itself)
    GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
