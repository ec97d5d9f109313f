"""Kill-and-resume smoke: a real SIGKILL mid-solve, then a bit-identical
resume.

The port's mirror of ``benchmarks/resume_smoke.py``, on ``device``.  The
parent solves the instance uninterrupted in-process (the baseline), then
starts a child process (``python -m repro_torch.bench.resume_smoke
--child``) running the same solve with a checkpoint at every chunk boundary,
SIGKILLs it as soon as a checkpoint is on disk, and resumes from the
survivors with :meth:`SolverSession.resume`: the result must equal the
baseline (modulo wall clock and the durability counters).

A double-kill cycle then SIGKILLs the recovery itself: a second child
resumes from the survivors while checkpointing into the same directory, is
killed once a newer generation is durable, and the final in-process resume
must still equal its baseline.  A further cycle kills a saturating
``frontier_spill`` solve whose checkpoints carry a non-empty cold tier: the
resume must equal its baseline, the spill counters included.

Also recorded: a checkpoint's write cost (checkpointed vs plain solve
wall), its size on disk and the resume's wall.  The children run on
``device`` too (each pays a process start and, on the card, a CUDA context).

Usage:
  PYTHONPATH=src python -m repro_torch.bench.resume_smoke [--smoke] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2]
CHILD_TIMEOUT_S = 300


def workload(smoke: bool, spill: bool = False, deep: bool = False):
    """The one seeded workload both processes build: (graph, config)."""
    from repro_torch.api import SolveConfig
    from repro_torch.graphs.generators import erdos_renyi

    if deep:
        # many chunks remain after the first kill, so the recovery child
        # writes new generations before it is killed too
        return erdos_renyi(44, 0.25, seed=5), SolveConfig(
            num_workers=4, steps_per_round=2, chunk_rounds=1, checkpoint_every=1)
    if spill:
        return erdos_renyi(40, 0.28, seed=0), SolveConfig(
            num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=16,
            frontier_spill=True, checkpoint_every=1)
    return erdos_renyi(36 if smoke else 40, 0.25, seed=3), SolveConfig(
        num_workers=4, steps_per_round=2, chunk_rounds=1, checkpoint_every=1)


def _child(ckpt_dir: str, smoke: bool, spill: bool, resume: bool, deep: bool,
           device) -> None:
    from repro_torch.api import SolverSession

    if resume:
        # the recovery child resumes and keeps checkpointing into the same
        # directory, so the parent can SIGKILL it mid-recovery
        SolverSession.resume(ckpt_dir, checkpoint_dir=ckpt_dir, device=device)
        return
    g, cfg = workload(smoke, spill, deep)
    SolverSession(config=cfg, device=device).solve(g, checkpoint_dir=ckpt_dir)


def _dir_bytes(d: str) -> int:
    total = 0
    for root, _, files in os.walk(d):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def _spawn(d: str, smoke: bool, device, *flags) -> subprocess.Popen:
    argv = [sys.executable, "-m", "repro_torch.bench.resume_smoke", "--child",
            "--dir", d, "--device", str(device), *flags]
    if smoke:
        argv.append("--smoke")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(argv, env=env)


def _kill_when(proc: subprocess.Popen, ready, poll_s: float) -> bool:
    """SIGKILL ``proc`` once ``ready()``; False if it ended first."""
    try:
        deadline = time.time() + CHILD_TIMEOUT_S
        while time.time() < deadline:
            if ready():
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                return True
            if proc.poll() is not None:
                return False
            time.sleep(poll_s)
        raise RuntimeError(f"child made no checkpoint within {CHILD_TIMEOUT_S}s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _kill_and_resume(smoke: bool, cache, device, spill: bool = False):
    """SIGKILL the checkpointing child at its first durable step and resume
    from the survivors.  Returns (result, killed_at_step, killed_mid_solve,
    resume_wall_s)."""
    from repro_torch.api import SolverSession
    from repro_torch.checkpoint.store import latest_step

    d = tempfile.mkdtemp(prefix="resume_smoke_kill_")
    try:
        proc = _spawn(d, smoke, device, *(["--spill"] if spill else []))
        killed = _kill_when(proc, lambda: latest_step(d) is not None, 0.05)
        step = latest_step(d)
        assert step is not None, "no checkpoint survived the kill"
        t0 = time.perf_counter()
        resumed = SolverSession.resume(d, cache=cache, checkpoint_dir=None, device=device)
        resume_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return resumed, step, killed, resume_wall


def _kill_mid_recovery(smoke: bool, cache, device):
    """The double-kill cycle.  Returns (result, first_kill_step,
    recovery_kill_step, recovery_killed_mid_solve); a recovery that finished
    before a newer generation landed is recorded, not failed."""
    from repro_torch.api import SolverSession
    from repro_torch.checkpoint.store import latest_step

    d = tempfile.mkdtemp(prefix="resume_smoke_kill2_")
    try:
        _kill_when(_spawn(d, smoke, device, "--deep"), lambda: latest_step(d) is not None,
                   0.002)
        step1 = latest_step(d)
        assert step1 is not None, "no checkpoint survived the first kill"

        def newer():
            latest = latest_step(d)
            return latest is not None and latest > step1

        killed = _kill_when(_spawn(d, smoke, device, "--deep", "--resume"), newer, 0.002)
        step2 = latest_step(d)
        assert step2 is not None and step2 >= step1
        resumed = SolverSession.resume(d, cache=cache, checkpoint_dir=None, device=device)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return resumed, step1, step2, killed


def _assert_same(a, b, spill: bool = False) -> None:
    assert a.best_size == b.best_size
    assert a.rounds == b.rounds
    assert a.nodes_expanded == b.nodes_expanded
    assert a.tasks_transferred == b.tasks_transferred
    assert a.stats.transfer_bytes_total == b.stats.transfer_bytes_total
    assert (np.asarray(a.best_sol) == np.asarray(b.best_sol)).all()
    if spill:
        assert a.stats.spilled_tasks == b.stats.spilled_tasks
        assert a.stats.readmitted_tasks == b.stats.readmitted_tasks
        assert a.stats.overflow_count == 0 and not a.stats.overflow


def run(smoke: bool = False, device="cuda") -> dict:
    from repro_torch.api import PlaneCache, SolverSession
    from repro_torch.checkpoint.store import latest_step

    g, cfg = workload(smoke)
    cache = PlaneCache()

    SolverSession(config=cfg, cache=cache, device=device).solve(g)  # warm-up
    t0 = time.perf_counter()
    base = SolverSession(config=cfg, cache=cache, device=device).solve(g)
    plain_wall = time.perf_counter() - t0

    d_cost = tempfile.mkdtemp(prefix="resume_smoke_cost_")
    try:
        t0 = time.perf_counter()
        ck_run = SolverSession(config=cfg, cache=cache, device=device).solve(
            g, checkpoint_dir=d_cost)
        ckpt_wall = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(os.path.join(d_cost, f"step_{latest_step(d_cost)}"))
        writes = ck_run.stats.checkpoints_written
    finally:
        shutil.rmtree(d_cost, ignore_errors=True)

    resumed, step, killed_mid_solve, resume_wall = _kill_and_resume(smoke, cache, device)
    _assert_same(resumed, base)

    g_dp, cfg_dp = workload(smoke, deep=True)
    base_dp = SolverSession(config=cfg_dp, cache=cache, device=device).solve(g_dp)
    res2, kill1_step, kill2_step, killed_mid_recovery = _kill_mid_recovery(
        smoke, cache, device)
    _assert_same(res2, base_dp)

    g_sp, cfg_sp = workload(smoke, spill=True)
    base_sp = SolverSession(config=cfg_sp, cache=cache, device=device).solve(g_sp)
    assert base_sp.stats.spilled_tasks > 0, "the spill workload no longer saturates"
    res_sp, sp_step, sp_killed, _ = _kill_and_resume(smoke, cache, device, spill=True)
    _assert_same(res_sp, base_sp, spill=True)

    out = dict(
        n=g.n,
        rounds=int(base.rounds),
        killed_mid_solve=killed_mid_solve,
        killed_at_step=int(step),
        resumed_best=int(resumed.best_size),
        bit_identical=True,
        plain_wall_s=round(plain_wall, 3),
        checkpointed_wall_s=round(ckpt_wall, 3),
        checkpoint_overhead_pct=round(
            100.0 * (ckpt_wall - plain_wall) / max(plain_wall, 1e-9), 1),
        checkpoints_written=int(writes),
        checkpoint_bytes=int(ckpt_bytes),
        resume_wall_s=round(resume_wall, 3),
        recovery_first_kill_step=int(kill1_step),
        recovery_second_kill_step=int(kill2_step),
        killed_mid_recovery=killed_mid_recovery,
        recovery_bit_identical=True,
        spill_killed_at_step=int(sp_step),
        spill_killed_mid_solve=sp_killed,
        spill_resumed_best=int(res_sp.best_size),
        spill_spilled_tasks=int(res_sp.stats.spilled_tasks),
        spill_readmitted_tasks=int(res_sp.stats.readmitted_tasks),
        spill_bit_identical=True,
    )
    print(
        f"kill-and-resume: SIGKILL at step {step} "
        f"({'mid-solve' if killed_mid_solve else 'after finish'}), resume "
        f"bit-identical (best={out['resumed_best']}, rounds={out['rounds']}); "
        f"checkpoint {out['checkpoint_bytes']}B, write overhead "
        f"{out['checkpoint_overhead_pct']}% at every-chunk cadence, resume "
        f"{out['resume_wall_s']}s"
    )
    second = (f"SIGKILL the recovery at step {kill2_step}" if killed_mid_recovery
              else "recovery finished before a second kill landed")
    print(f"mid-recovery kill: SIGKILL at step {kill1_step}, then {second}; "
          f"final resume bit-identical")
    print(f"mid-spill kill: SIGKILL at step {sp_step} with a live cold tier, resume "
          f"bit-identical (best={out['spill_resumed_best']}, "
          f"{out['spill_spilled_tasks']} spilled / {out['spill_readmitted_tasks']} "
          f"readmitted, 0 dropped)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.resume_smoke")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spill", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--deep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.dir, args.smoke, args.spill, args.resume, args.deep, args.device)
    else:
        run(args.smoke, args.device)


if __name__ == "__main__":
    main()
