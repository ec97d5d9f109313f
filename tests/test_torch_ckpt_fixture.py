"""A checkpoint written by the JAX package, for the port to resume on the card.

Run as a script, it solves G(34, 0.25, seed 3) with the JAX package (4
workers, 2 steps a round, a chunk a round, a checkpoint every chunk: a
solve of the size of ``tests/golden_vc.json``) and writes
``src/repro_torch/data/ckpt_jax_vc/``: the checkpoint of its middle step,
``step_<N>/`` (about 10 kB), and ``record.json`` with the uninterrupted
JAX result:

  PYTHONPATH=src python tests/test_torch_ckpt_fixture.py

``chip_smoke.py`` reads the directory from the checkout and resumes the
checkpoint on the card.  Run as a test, it checks that the JAX package
still writes the same arrays and manifest, and that the port resumes the
checkpoint on the CPU to the record.
"""

import json
import os
import pathlib
import shutil
import tempfile

import numpy as np

from repro.api import SolveConfig, SolverSession
from repro.checkpoint.solve import SolveCheckpoint
from repro.graphs.generators import erdos_renyi

OUT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "src" / "repro_torch" / "data" / "ckpt_jax_vc"
)

GRAPH = dict(n=34, p=0.25, seed=3)
SOLVE_KW = dict(num_workers=4, steps_per_round=2, chunk_rounds=1, checkpoint_every=1)
# the directory name the checkpoint was written under: it is in its config
CKPT_NAME = "ckpt_jax_vc"


def record(r) -> dict:
    return {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
    }


def jax_checkpoints(workdir: str):
    """Solve with the JAX package, checkpointing every chunk under
    ``workdir/CKPT_NAME`` (a relative name, so no absolute path lands in
    the manifests); returns (the uninterrupted record, the middle step)."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        g = erdos_renyi(GRAPH["n"], GRAPH["p"], GRAPH["seed"])
        r = SolverSession(config=SolveConfig(**SOLVE_KW)).solve(g, checkpoint_dir=CKPT_NAME)
    finally:
        os.chdir(cwd)
    steps = sorted(int(p[5:]) for p in os.listdir(os.path.join(workdir, CKPT_NAME)))
    return record(r), steps[len(steps) // 2]


def test_jax_still_writes_the_fixture():
    doc = json.loads((OUT / "record.json").read_text())
    assert doc["graph"] == GRAPH and doc["solve_kw"] == SOLVE_KW
    with tempfile.TemporaryDirectory() as tmp:
        rec, step = jax_checkpoints(tmp)
        assert rec == doc["result"] and step == doc["step"]
        fresh = pathlib.Path(tmp) / CKPT_NAME / f"step_{step}"
        committed = OUT / f"step_{step}"
        assert (fresh / "manifest.msgpack").read_bytes() == \
            (committed / "manifest.msgpack").read_bytes()
        a = SolveCheckpoint.load(str(fresh))
        b = SolveCheckpoint.load(str(committed))
        assert sorted(a.arrays) == sorted(b.arrays)
        for name in a.arrays:
            assert a.arrays[name].dtype == b.arrays[name].dtype, name
            assert (a.arrays[name] == b.arrays[name]).all(), name


def test_port_resumes_the_fixture_on_the_cpu():
    from repro_torch.api import SolverSession as PortSession

    doc = json.loads((OUT / "record.json").read_text())
    r = PortSession.resume(str(OUT / f"step_{doc['step']}"), device="cpu",
                           checkpoint_dir=None)
    assert record(r) == doc["result"]
    assert r.stats.resumed_from
    # the directory form resumes its one (newest) step
    assert record(PortSession.resume(str(OUT), device="cpu", checkpoint_dir=None)) \
        == doc["result"]


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        rec, step = jax_checkpoints(tmp)
        shutil.rmtree(OUT, ignore_errors=True)
        OUT.mkdir(parents=True)
        shutil.copytree(pathlib.Path(tmp) / CKPT_NAME / f"step_{step}", OUT / f"step_{step}")
    doc = {"graph": GRAPH, "solve_kw": SOLVE_KW, "step": step, "result": rec}
    (OUT / "record.json").write_text(json.dumps(doc, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} (step {step}, {size} bytes): {rec}")
