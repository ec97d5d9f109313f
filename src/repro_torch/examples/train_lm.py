"""End-to-end training with a checkpoint, a "crash" and a resume.

The port's twin of ``examples/train_lm.py``, on ``--device`` (the card by
default): a reduced model trained to half its steps with checkpoints, then
resumed from the latest one to the end, then an uninterrupted control run;
the resumed loss curve must reproduce the control's (max drift below 1e-3,
the JAX example's criterion).

  PYTHONPATH=src python -m repro_torch.examples.train_lm [arch] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.checkpoint.store import wait_for_pending
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train_loop


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_lm")
    ap.add_argument("arch", nargs="?", default="minitron_4b")
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg, steps = get_smoke_config(args.arch), args.steps
    print(f"arch={cfg.name} steps={steps}")
    run = dict(batch=8, seq=128, seed=1, device=args.device)

    ckdir = tempfile.mkdtemp(prefix="repro_ck_")
    try:
        half = steps // 2
        print(f"\n--- phase 1: train to step {half}, checkpoint, 'crash' ---")
        _, _, l1 = train_loop(cfg, steps=half, ckpt_dir=ckdir, ckpt_every=max(half // 4, 1),
                              log_every=25, **run)
        wait_for_pending()
        print("\n--- phase 2: resume from the latest checkpoint ---")
        _, _, l2 = train_loop(cfg, steps=steps, ckpt_dir=ckdir, ckpt_every=10_000,
                              resume=True, log_every=25, **run)
        print("\n--- control: uninterrupted run ---")
        _, _, lc = train_loop(cfg, steps=steps, log_every=50, **run)
        resumed = l1 + l2
        drift = float(np.abs(np.array(resumed) - np.array(lc)).max())
        print(f"\nresume-vs-control max loss drift: {drift:.2e} "
              f"({'EXACT' if drift < 1e-3 else 'MISMATCH'})")
        print(f"loss: {lc[0]:.3f} -> {lc[-1]:.3f}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return drift


if __name__ == "__main__":
    main()
