"""Batched LM serving on the card: a prefill, then greedy decode.

The port of the JAX package's ``examples/serve_lm.py`` decode path:
``greedy_decode`` fills the decode cache token by token over the prompt,
then takes ``gen`` tokens by argmax, as the example does; before it, the
prefill runs ``Model.forward`` over the whole batch of prompts.  Weights are
the port's seeded init (no weights exist in the repo).  It runs on the card
unless ``--device cpu`` asks for the CPU, and raises without CUDA.  The
example's balancer demonstration waits with the examples (ROADMAP queue 1,
item 12).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_lm                 # qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6-3b \\
      --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.session import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.registry import get_model


def greedy_decode(model, params, prompts: torch.Tensor, gen: int):
    """prompts (B, P) -> (generated (B, gen), the decode path's logits at
    the last prompt token (B, vocab)), through the decode cache."""
    B, P = prompts.shape
    if P < 1:
        raise ValueError("greedy_decode needs a prompt of at least one token")
    cache = model.init_decode_cache(B, P + gen + 1, device=prompts.device)
    for t in range(P):
        logits, cache = model.decode_fn(params, cache, prompts[:, t : t + 1])
    prompt_logits = logits[:, -1]
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(gen):
        out.append(tok)
        logits, cache = model.decode_fn(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return torch.cat(out, dim=1), prompt_logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="a dense or ssm arch id or alias (qwen1.5-0.5b, rwkv6-3b, ...)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (reduced widths, f32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; there is no silent "
                         "fallback to the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    ).to(device)

    _sync(device)
    t0 = time.perf_counter()
    logits = model.forward(params, {"tokens": prompts})
    _sync(device)
    prefill_s = time.perf_counter() - t0
    n_prompt = args.batch * args.prompt_len
    print(f"[serve_lm] {cfg.name} on {device}: prefill {tuple(prompts.shape)} in "
          f"{prefill_s:.3f}s ({n_prompt / prefill_s:.1f} tok/s)")

    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, params, prompts, args.gen)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"[serve_lm] generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve_lm] sample:", toks[0, :16].tolist())
    return {"logits": logits, "tokens": toks, "prefill_s": prefill_s, "decode_s": dt}


if __name__ == "__main__":
    main()
