"""JAX-made references of spilled solves, for the port to reproduce on the card.

Run as a script, it solves with the JAX package and writes two fixtures:

* ``src/repro_torch/data/golden_spill.json``: the records of spilled solves
  at n = 40-48 (``CASES``: the saturating ``_SAT`` shape of
  ``tests/test_spill.py`` with both codecs, FPT with k = 29, G(48, 0.25)
  on 2 workers, and ``solve_many`` of ``tests/test_spill.py``'s four
  instances across one compaction), each field for field with its spill
  counters;
* ``src/repro_torch/data/ckpt_jax_vc_spill/``: a solo checkpoint taken
  mid-spill, ``step_<N>/`` (a few kB), and ``record.json`` with the
  uninterrupted JAX result.  The shape is ``_SAT`` with 2 workers: with 4,
  no chunk boundary of the solve holds a cold record (each pump refills the
  other workers from what it just spilled).  ``step_<N>`` is the boundary
  whose cold tier holds the most records.

  PYTHONPATH=src python tests/test_torch_spill_fixture.py

``chip_smoke.py`` phase 13 reads both from the checkout.  Run as a test, it
checks that the JAX package still writes the same fixtures and that the
port reproduces both on the CPU.
"""

import json
import os
import pathlib
import shutil
import tempfile

import numpy as np

from repro.api import SolveConfig, SolverSession
from repro.checkpoint.solve import SolveCheckpoint
from repro.graphs import generators

DATA = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "data"
GOLDEN = DATA / "golden_spill.json"
CKPT = DATA / "ckpt_jax_vc_spill"
# the directory name the checkpoint was written under: it is in its config
CKPT_NAME = "ckpt_jax_vc_spill"

_SAT = dict(num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=16,
            frontier_spill=True)
_G40 = {"generator": "erdos_renyi", "n": 40, "p": 0.28, "seed": 0}
CASES = {
    "solo_optimized": dict(graphs=[_G40], solve_kw=_SAT),
    "solo_basic": dict(graphs=[_G40], solve_kw={**_SAT, "spill_codec": "basic"}),
    "fpt_k29": dict(graphs=[_G40], solve_kw={**_SAT, "mode": "fpt", "k": 29}),
    "solo_n48_2workers": dict(
        graphs=[{"generator": "erdos_renyi", "n": 48, "p": 0.25, "seed": 0}],
        solve_kw={**_SAT, "num_workers": 2}),
    "many_compaction": dict(
        graphs=[{**_G40, "seed": s} for s in range(3)]
        + [{"generator": "erdos_renyi", "n": 18, "p": 0.35, "seed": 2}],
        solve_kw={**_SAT, "compact_threshold": 0.7}),
}
CKPT_GRAPH = _G40
CKPT_KW = {**_SAT, "num_workers": 2, "checkpoint_every": 1}


def record(r) -> dict:
    s = r.stats
    return {
        "best_size": int(r.best_size),
        "best_sol": (None if r.best_sol is None
                     else [int(w) for w in np.asarray(r.best_sol, np.uint32)]),
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


def build(gen, spec):
    return getattr(gen, spec["generator"])(
        **{k: v for k, v in spec.items() if k != "generator"})


def run_case(session_cls, config_cls, gen, case, **kw) -> list:
    """The records of one case's solve (one per graph), in either package."""
    session = session_cls(config=config_cls(**case["solve_kw"]), **kw)
    graphs = [build(gen, g) for g in case["graphs"]]
    if len(graphs) == 1:
        return [record(session.solve(graphs[0]))]
    return [record(r) for r in session.solve_many(graphs).results]


def jax_golden() -> dict:
    return {name: {**case, "results": run_case(SolverSession, SolveConfig, generators, case)}
            for name, case in CASES.items()}


def _cold_records(arrays: dict) -> int:
    return sum(v.shape[0] for k, v in arrays.items() if k.startswith("spill.w"))


def jax_checkpoints(workdir: str):
    """Solve with the JAX package, checkpointing every chunk under
    ``workdir/CKPT_NAME`` (a relative name, so no absolute path lands in
    the manifests); returns (the uninterrupted record, the step whose cold
    tier holds the most records, that count)."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        r = SolverSession(config=SolveConfig(**CKPT_KW)).solve(
            build(generators, CKPT_GRAPH), checkpoint_dir=CKPT_NAME)
    finally:
        os.chdir(cwd)
    d = os.path.join(workdir, CKPT_NAME)
    cold = {int(p[5:]): _cold_records(SolveCheckpoint.load(d, int(p[5:])).arrays)
            for p in os.listdir(d)}
    step = max(sorted(cold), key=lambda s: cold[s])
    return record(r), step, cold[step]


def test_jax_still_writes_the_fixtures():
    assert json.loads(GOLDEN.read_text()) == jax_golden()
    doc = json.loads((CKPT / "record.json").read_text())
    assert doc["graph"] == CKPT_GRAPH and doc["solve_kw"] == CKPT_KW
    with tempfile.TemporaryDirectory() as tmp:
        rec, step, cold = jax_checkpoints(tmp)
        assert rec == doc["result"] and step == doc["step"] and cold == doc["cold_records"] > 0
        fresh = pathlib.Path(tmp) / CKPT_NAME / f"step_{step}"
        committed = CKPT / f"step_{step}"
        assert (fresh / "manifest.msgpack").read_bytes() == \
            (committed / "manifest.msgpack").read_bytes()
        a = SolveCheckpoint.load(str(fresh))
        b = SolveCheckpoint.load(str(committed))
        assert sorted(a.arrays) == sorted(b.arrays)
        for name in a.arrays:
            assert a.arrays[name].dtype == b.arrays[name].dtype, name
            assert (a.arrays[name] == b.arrays[name]).all(), name


def test_port_reproduces_the_fixtures_on_the_cpu():
    from repro_torch.api import SolveConfig as PortConfig
    from repro_torch.api import SolverSession as PortSession
    from repro_torch.checkpoint.solve import SolveCheckpoint as PortCheckpoint
    from repro_torch.graphs import generators as port_generators

    for name, case in json.loads(GOLDEN.read_text()).items():
        got = run_case(PortSession, PortConfig, port_generators, case, device="cpu")
        assert got == case["results"], name
    doc = json.loads((CKPT / "record.json").read_text())
    step_dir = CKPT / f"step_{doc['step']}"
    arrays = PortCheckpoint.load(str(step_dir)).arrays
    assert sum(v.shape[0] for k, v in arrays.items() if k.startswith("spill.w")) \
        == doc["cold_records"]
    r = PortSession.resume(str(step_dir), device="cpu", checkpoint_dir=None)
    assert record(r) == doc["result"]
    assert r.stats.resumed_from


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
    with tempfile.TemporaryDirectory() as tmp:
        rec, step, cold = jax_checkpoints(tmp)
        shutil.rmtree(CKPT, ignore_errors=True)
        CKPT.mkdir(parents=True)
        shutil.copytree(pathlib.Path(tmp) / CKPT_NAME / f"step_{step}", CKPT / f"step_{step}")
    doc = {"graph": CKPT_GRAPH, "solve_kw": CKPT_KW, "step": step, "cold_records": cold,
           "result": rec}
    (CKPT / "record.json").write_text(json.dumps(doc, indent=1) + "\n")
    size = sum(p.stat().st_size for p in CKPT.rglob("*") if p.is_file())
    print(f"wrote {CKPT} (step {step}, {cold} cold records, {size} bytes): {rec}")
