"""Batched LM serving with the semi-centralized request balancer (beyond-
paper integration): greedy decode on a smoke model, then the balancer
keeping 8 simulated replicas busy under a hot-shard arrival pattern.

The port's twin of ``examples/serve_lm.py``, on ``--device`` (the card by
default).  The decode is ``repro_torch.launch.serve_lm.greedy_decode`` over
the port's seeded init (the JAX example's weights come from ``jax.random``,
which the port does not draw), so the sampled tokens are the port's own; the
balancer's numbers, a host simulation over the same seeded arrivals, are the
JAX example's.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.session import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve_lm import greedy_decode
from repro_torch.models.registry import get_model
from repro_torch.serving.balancer import simulate


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_lm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, params, prompts, args.gen)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    print(f"[serve_lm] generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve_lm] sample:", toks[0, :16].numpy())

    # balancer demonstration: hot-shard arrival pattern, with/without
    works = list(rng.integers(8, 256, 64))
    on = simulate(args.replicas, 8, works, balance=True, seed=args.seed)
    off = simulate(args.replicas, 8, works, balance=False, seed=args.seed)
    print(
        f"[balancer] makespan {off['rounds']} -> {on['rounds']} rounds "
        f"({off['rounds']/on['rounds']:.1f}x), idle-slot-steps "
        f"{off['idle_slot_steps']} -> {on['idle_slot_steps']}, "
        f"{on['transfers']} transfers, "
        f"{on['control_ints_per_round']} control ints/round"
    )
    return {"tokens": toks, "balanced": on, "unbalanced": off}


if __name__ == "__main__":
    main()
