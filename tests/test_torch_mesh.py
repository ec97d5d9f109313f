"""The port's multi-device solve: one worker a rank of a ``torch.distributed``
group (gloo ranks on the CPU, started by ``spawn_mesh``), held against the
port's single-process solve, the JAX package's goldens and solves, and the
JAX package's refusals.

The ranks run in four jobs (a 5-rank one, a 4-rank one holding most
cases, a 2-rank one whose rank raises, and the CLI's own 4 ranks); each
module-scoped fixture starts its job once and the tests read its results.
Every rank returns the same result; every job is bounded by its timeout.

* (a) every solo golden of ``tests/golden_vc.json`` (P 4-5: sparse and
  gather, the basic codec, lanes 2 with ``donate_k`` 3, the random policy,
  chunk 1) and the FPT golden, field for field, with ``reduce_sweeps``
  equal to the single-process solve's;
* (b) max clique and MIS on G(16, 0.4, seeds 0-2) on 4 ranks equal to the
  port's single-process solve and to the JAX solve;
* (c) ``explore_impl="reference"`` on the mesh;
* (e) a mesh checkpoint holds the single-process checkpoint's arrays and
  resumes in the port's single-process solve and in JAX's to the
  uninterrupted result; a single-process checkpoint resumes on the mesh;
* (f) one-crash fault plans on the mesh (replayed from the startup, and
  from a checkpoint): the fault-free result and the single-process
  injector report;
* (g) the refusals: spill, ``solve_many`` and the service with the JAX
  package's texts, a world size or mesh unlike ``num_workers``, and
  ``use_mesh`` without a process group; no CUDA, no rank on the card;
* (h) a rank that raises fails its job with that rank's traceback, fast;
* (i) ``launch.solve --use-mesh --device cpu --workers 4`` prints the JAX
  CLI's ``[solve]`` lines (run without a mesh).

The mesh superstep against JAX's ``shard_map`` superstep, step by step, is
``tests/test_torch_mesh_jax.py``.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_mesh_jobs as jobs
from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.api.service import SolveService as JaxService
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import SolveConfig, SolverSession, SolveService
from repro_torch.checkpoint.solve import SolveCheckpoint
from repro_torch.faults import FaultEvent, FaultInjector, FaultPlan
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.launch.mesh import make_solver_mesh, rank_device, spawn_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_vc.json").read_text())
TIMEOUT_S = 300.0

SMALL = [dict(n=16, p=0.4, seed=s) for s in range(3)]
CLIQUE_KW = dict(num_workers=4, steps_per_round=2, chunk_rounds=2)
# a trajectory of about 30 supersteps, 15 chunks
LONG = dict(n=48, p=0.25, seed=77)
LONG_KW = dict(num_workers=4, steps_per_round=2, chunk_rounds=2)
# result fields that record durability and differ between a resumed run
# and an uninterrupted one
DURABILITY = ("checkpoints_written", "resumed_from")


def _golden_cases(workers: int) -> list:
    cases = [
        (label, "vertex_cover", c["graph"], jobs.config_kw(c["solve_kw"]), c["result"])
        for label, c in GOLDEN["solo"].items()
        if c["solve_kw"]["num_workers"] == workers
    ]
    if workers == 4:
        f = GOLDEN["fpt"]
        cases.append(("fpt", "vertex_cover", f["graph"],
                      dict(num_workers=4, mode="fpt", k=f["k"]), f["result"]))
    return cases


GOLDEN5 = _golden_cases(5)
GOLDEN4 = _golden_cases(4)
PROBLEM_CASES = [
    (f"{problem}_{g['seed']}", problem, g, CLIQUE_KW)
    for problem in ("max_clique", "mis") for g in SMALL
]
REFERENCE_CASE = ("reference", "vertex_cover", GOLDEN["solo"]["multi_lane_donate"]["graph"],
                  dict(jobs.config_kw(GOLDEN["solo"]["multi_lane_donate"]["solve_kw"]),
                       explore_impl="reference"))
# (label, crash boundary, checkpoint every N chunks or None)
CRASH_CASES = [("replay", 3, None), ("from_checkpoint", 5, 2)]


def _crash_kw(case, ckpt_dir) -> dict:
    _, _, every = case
    if every is None:
        return LONG_KW
    return dict(LONG_KW, checkpoint_dir=str(ckpt_dir), checkpoint_every=every)


def _solo(problem: str, graph: dict, kw: dict, **solve_kw) -> dict:
    """The port's single-process solve of the same case, as a result dict."""
    session = SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu")
    return jobs.result_dict(session.solve(jobs._graph(graph), **solve_kw))


def _jax(problem: str, graph: dict, kw: dict, **solve_kw) -> dict:
    g = jax_erdos_renyi(graph["n"], graph["p"], graph["seed"])
    d = JaxSession(problem=problem, config=JaxConfig(**kw)).solve(g, **solve_kw).to_dict()
    d.pop("wall_s")
    return d


def _ranks_agree(results: list, key: str):
    """Rank 0's entry ``key``, after checking every rank returned it."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert res[key] == first, f"rank {r} differs on {key}"
    return first


def _ok(entry):
    assert not (isinstance(entry, dict) and "error" in entry), entry.get("error")
    return entry


def _golden_fields(d: dict) -> dict:
    """A result dict in the golden's record layout."""
    s = d["stats"]
    return {
        "best_size": d["best_size"], "best_sol": d["best_sol"], "rounds": d["rounds"],
        "nodes_expanded": d["nodes_expanded"], "tasks_transferred": d["tasks_transferred"],
        "transfer_rounds": s["transfer_rounds"],
        "transfer_bytes_total": s["transfer_bytes_total"], "overflow": s["overflow"],
    }


def _without(d: dict, *names) -> dict:
    d = json.loads(json.dumps(d))
    for name in names:
        d["stats"].pop(name, None)
    return d


# -- the jobs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def job5():
    cases = [c[:4] for c in GOLDEN5]
    return spawn_mesh(jobs.job, 5, device="cpu", timeout_s=TIMEOUT_S,
                      args=([("goldens", "solve_cases", (cases,))],))


@pytest.fixture(scope="module")
def single_ckpt(tmp_path_factory):
    """A single-process solve of LONG with a checkpoint every chunk."""
    d = tmp_path_factory.mktemp("single_ckpt")
    r = _solo("vertex_cover", LONG, dict(LONG_KW, checkpoint_dir=str(d), checkpoint_every=1))
    return d, r


@pytest.fixture(scope="module")
def job4(tmp_path_factory, single_ckpt):
    d, _ = single_ckpt
    mesh_ck = tmp_path_factory.mktemp("mesh_ckpt")
    parts = [
        ("goldens", "solve_cases", ([c[:4] for c in GOLDEN4],)),
        ("problems", "solve_cases", (PROBLEM_CASES,)),
        ("reference", "solve_cases", ([REFERENCE_CASE],)),
        ("durable", "durable", (LONG, LONG_KW, str(mesh_ck), str(d / "step_14"))),
        ("crashes", "crashes", (LONG, [
            (c[0], _crash_kw(c, tmp_path_factory.mktemp(f"crash_{c[0]}")), c[1])
            for c in CRASH_CASES])),
        ("refusals", "refusals", (LONG,)),
    ]
    assert (d / "step_14").is_dir()
    return mesh_ck, spawn_mesh(jobs.job, 4, device="cpu", timeout_s=TIMEOUT_S, args=(parts,))


# -- (a) the goldens ------------------------------------------------------------


@pytest.mark.parametrize("case", GOLDEN5 + GOLDEN4, ids=lambda c: c[0])
def test_goldens_on_the_mesh(case, job5, job4):
    label, problem, graph, kw, want = case
    results = job5 if kw["num_workers"] == 5 else job4[1]
    got = _ok(_ranks_agree(results, "goldens")[label])
    assert _golden_fields(got) == want
    assert got == _solo(problem, graph, kw)  # reduce_sweeps too
    assert got["stats"]["reduce_sweeps"] > 0


# -- (b) max clique and MIS ------------------------------------------------------


@pytest.mark.parametrize("case", PROBLEM_CASES, ids=lambda c: c[0])
def test_max_clique_and_mis_equal_single_process_and_jax(case, job4):
    label, problem, graph, kw = case
    got = _ok(_ranks_agree(job4[1], "problems")[label])
    assert got == _solo(problem, graph, kw)
    want = _jax(problem, graph, kw)
    assert {k: v for k, v in got.items() if k != "stats"} == {
        k: v for k, v in want.items() if k != "stats"}
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
    assert got["found"] and got["rounds"] > 1


# -- (c) the reference explore route ----------------------------------------------


def test_reference_explore_on_the_mesh(job4):
    label, problem, graph, kw = REFERENCE_CASE
    got = _ok(_ranks_agree(job4[1], "reference")[label])
    assert got == _solo(problem, graph, kw)
    assert _golden_fields(got) == GOLDEN["solo"]["multi_lane_donate"]["result"]


# -- (e) checkpoints across the mesh, the single process and JAX ------------------


def _uninterrupted():
    return _solo("vertex_cover", LONG, LONG_KW)


def test_mesh_checkpoints_are_the_single_process_files(job4, single_ckpt):
    mesh_ck, results = job4
    single_dir, single = single_ckpt
    written = _ok(_ranks_agree(results, "durable")["written"])
    assert written == single  # checkpoints_written included
    steps = sorted(p.name for p in mesh_ck.iterdir())
    assert steps == sorted(p.name for p in single_dir.iterdir()) and len(steps) > 4
    for step in steps:
        a = SolveCheckpoint.load(str(mesh_ck / step))
        b = SolveCheckpoint.load(str(single_dir / step))
        assert a.fingerprint == b.fingerprint and a.rounds == b.rounds
        assert a.meta == b.meta and sorted(a.arrays) == sorted(b.arrays)
        for name in a.arrays:
            assert (np.asarray(a.arrays[name]) == np.asarray(b.arrays[name])).all(), name
        assert a.config["use_mesh"] and not b.config["use_mesh"]


def test_mesh_checkpoint_resumes_single_process_in_both_packages(job4):
    mesh_ck, _ = job4
    middle = str(mesh_ck / "step_10")
    want = _without(_uninterrupted(), *DURABILITY)
    port = _solo("vertex_cover", LONG, LONG_KW, resume_from=middle)
    assert _without(port, *DURABILITY) == want  # reduce_sweeps from the meta
    assert port["rounds"] == want["rounds"] > 10
    jax = _without(_jax("vertex_cover", LONG, LONG_KW, resume_from=middle), *DURABILITY)
    assert {k: v for k, v in jax.items() if k != "stats"} == {
        k: v for k, v in want.items() if k != "stats"}
    assert {k: want["stats"][k] for k in jax["stats"]} == jax["stats"]


def test_single_process_checkpoint_resumes_on_the_mesh(job4):
    got = _ok(_ranks_agree(job4[1], "durable")["resumed"])
    assert got["stats"]["resumed_from"].endswith("step_14")
    # reduce_sweeps from the checkpoint's running sum
    assert _without(got, *DURABILITY) == _without(_uninterrupted(), *DURABILITY)


# -- (f) a crash on the mesh ---------------------------------------------------------


@pytest.mark.parametrize("case", CRASH_CASES, ids=lambda c: c[0])
def test_a_crash_on_the_mesh_heals_to_the_fault_free_result(case, job4, tmp_path):
    label, at, _ = case
    got = _ok(_ranks_agree(job4[1], "crashes")[label])
    inj = FaultInjector(FaultPlan(events=(FaultEvent("crash", at=at),)))
    kw = _crash_kw(case, tmp_path / "single")
    assert got["result"] == _solo("vertex_cover", LONG, kw, injector=inj)
    assert got["report"] == inj.report()
    assert got["report"]["injected"]["crash"] == got["report"]["recovered"]["crash"] == 1
    # the fault-free run's, but for the checkpoints the replay wrote again
    clean = _solo("vertex_cover", LONG, _crash_kw(case, tmp_path / "clean"))
    assert _without(got["result"], "checkpoints_written") == _without(
        clean, "checkpoints_written")


# -- (g) the refusals -----------------------------------------------------------


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_keep_the_jax_texts(job4):
    got = _ranks_agree(job4[1], "refusals")
    g = jax_erdos_renyi(LONG["n"], LONG["p"], LONG["seed"])
    assert got["spill"] == _jax_error(lambda: JaxSession(config=JaxConfig(
        num_workers=1, use_mesh=True, frontier_spill=True)).solve(g))
    assert got["solve_many"] == _jax_error(lambda: JaxSession(config=JaxConfig(
        num_workers=1, use_mesh=True)).solve_many([g, g]))
    assert got["world_size"] == ("a solver mesh has one worker per rank: num_workers=3 "
                                 "but the process group has 4 ranks")
    assert got["mesh_size"] == ("a solver mesh has one worker per rank: num_workers=5 "
                                "but the mesh has 4 ranks")
    want = _jax_error(lambda: JaxService("vertex_cover", JaxConfig(use_mesh=True)))
    with pytest.raises(ValueError) as e:
        SolveService("vertex_cover", SolveConfig(use_mesh=True), device="cpu")
    assert str(e.value) == want


def test_use_mesh_without_a_process_group_refuses():
    g = erdos_renyi(12, 0.3, 0)
    session = SolverSession(config=SolveConfig(num_workers=2, use_mesh=True), device="cpu")
    with pytest.raises(ValueError, match="initialized torch.distributed process group"):
        session.solve(g)
    with pytest.raises(ValueError, match="process group"):
        make_solver_mesh(2, device="cpu")


def test_the_mesh_runs_on_the_card_unless_asked(monkeypatch):
    """device=None means the card, and without CUDA it raises: no rank
    falls back to the CPU."""
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_mesh(jobs.raise_on_rank, 2, timeout_s=60.0, args=(0,))


# -- (h) a raising rank ---------------------------------------------------------------


def test_a_raising_rank_fails_the_job_fast():
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as e:
        spawn_mesh(jobs.raise_on_rank, 2, device="cpu", timeout_s=120.0, args=(1,))
    assert "mesh rank 1 of 2 raised" in str(e.value)
    assert time.perf_counter() - t < 60.0


# -- (i) the CLI ------------------------------------------------------------------------


def _solve_lines(module: str, *extra: str) -> list:
    args = ["--graph", "gnp", "--n", "36", "--p", "0.15", "--seed", "4",
            "--workers", "4", "--steps-per-round", "4", "--donate-k", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", module, *args, *extra],
        env=env, capture_output=True, text=True, check=True, timeout=TIMEOUT_S,
    ).stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("[solve]")]
    return [re.sub(r" wall=\S+", "", ln) for ln in lines]


def test_cli_use_mesh_prints_the_jax_solve_line():
    want = _solve_lines("repro.launch.solve")
    got = _solve_lines("repro_torch.launch.solve", "--device", "cpu", "--use-mesh")
    assert len(want) == 2 and got == want
    with pytest.raises(subprocess.CalledProcessError) as e:
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
             "--use-mesh", "--batch", "2", "--n", "20"],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, check=True, timeout=TIMEOUT_S,
        )
    assert ("multi-instance mode has no mesh path yet (vmap virtual workers only) "
            "— drop --use-mesh") in e.value.stderr
