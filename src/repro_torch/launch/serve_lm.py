"""Batched LM serving on the card: a prefill, then greedy decode.

The port of the JAX package's ``examples/serve_lm.py`` decode path:
``greedy_decode`` fills the decode cache token by token over the prompt,
then takes ``gen`` tokens by argmax, as the example does; before it, the
prefill runs ``Model.forward`` over the whole batch of prompts.  A VLM
prompt (pixtral) carries seeded stub patch embeddings (B, n_patches, d)
before its tokens in the prefill; decode sees the tokens only, as JAX's
``decode_fn`` takes no patch prefix.  An encoder-decoder prompt (whisper)
carries seeded stub frame embeddings (B, enc_seq, d): the prefill encodes
them, and ``greedy_decode`` primes the cross-attention cache from the same
frames, so decode and forward hear the same audio (given no frames it primes
with zeros, as the JAX example does).  Weights are the port's seeded init
(no weights exist in the repo).  ``main`` and ``greedy_decode`` run under
``torch.inference_mode()``: the parameters are trainable, and serving builds
no graph.  ``--layers N`` cuts depth and leaves every
width alone (JAX's ``launch/dryrun.py`` cuts depth the same way, an
encoder-decoder's encoder and decoder alike): a full-width
qwen3-moe-235b-a22b is ~470 GB in bf16, 8 of its 94 layers ~42 GB.  It runs
on the card unless ``--device cpu`` asks for the CPU, and raises without
CUDA.  The example's balancer demonstration is in its twin,
``repro_torch.examples.serve_lm``.  ``--expert-ranks M [--data-ranks D]``
serves an MoE config expert-parallel (``models/moe.py``'s ``moe_apply_ep``,
JAX's ``_moe_shard_map``) on D·M ranks of this host started by
``launch/mesh.py``'s ``spawn_mesh``: each holds E/M experts of every layer
and its data row's share of the prompts (gloo where ranks share a card,
NCCL with a card a rank).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_lm                 # qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6-3b \\
      --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-moe-235b-a22b \\
      --layers 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch pixtral-12b \\
      --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch recurrentgemma-9b \\
      --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch whisper-large-v3 \\
      --prompt-len 448 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-moe-235b-a22b \
      --smoke --device cpu --expert-ranks 2 --data-ranks 2
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-moe-235b-a22b \
      --layers 4 --prompt-len 1024 --gen 8 --expert-ranks 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.session import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import encdec
from repro_torch.models.convert import frames as stub_frames
from repro_torch.models.convert import patch_embeds
from repro_torch.models.layers import torch_dtype
from repro_torch.models.registry import get_model


def cut_depth(cfg, layers: int | None):
    """cfg with ``layers`` layers (an encoder-decoder's encoder too), every
    width kept; cfg itself for None."""
    if layers is None:
        return cfg
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers)


def prompt_batch(cfg, prompts: torch.Tensor, seed: int) -> dict:
    """The prefill's batch: the tokens, and a vlm's seeded patch prefix or
    an encoder-decoder's seeded frames."""
    batch = {"tokens": prompts}
    B = prompts.shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(patch_embeds(cfg, B, seed)).to(prompts.device)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(stub_frames(cfg, B, seed)).to(prompts.device)
    return batch


@torch.inference_mode()
def greedy_decode(model, params, prompts: torch.Tensor, gen: int, frames=None):
    """prompts (B, P) -> (generated (B, gen), the decode path's logits at
    the last prompt token (B, vocab)), through the decode cache.  An
    encoder-decoder's cache is primed first with ``frames`` (B, enc_seq, d),
    or with zeros when none are given, as the JAX example's
    ``greedy_decode`` does."""
    B, P = prompts.shape
    if P < 1:
        raise ValueError("greedy_decode needs a prompt of at least one token")
    cfg = model.cfg
    cache = model.init_decode_cache(B, P + gen + 1, device=prompts.device)
    if cfg.family == "encdec":
        if frames is None:
            frames = torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=torch_dtype(cfg),
                                 device=prompts.device)
        cache = encdec.prime_cross_cache(params, cache, frames)
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


@torch.inference_mode()
def serve_expert_parallel(mesh, spec: dict) -> dict:
    """One rank of ``main``'s expert-parallel run (``--expert-ranks M``,
    ``--data-ranks D``), started by ``spawn_mesh`` on D·M ranks: the rank's
    (data, model) place in the grid, the seeded init with its E/M experts
    (the same numbers as the one-process init), its data row's share of the
    prompts, the prefill and the greedy decode, both timed.  -> host values
    (numpy: a tensor would cross processes by a file descriptor that dies
    with the rank): the tokens generated for its prompts, the prefill's last
    logits, walls, and the prefill's launches and collectives (count, bytes)."""
    from repro_torch.kernels import counts
    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.models.transformer import init_expert_parallel

    D, M = spec["data_ranks"], spec["expert_ranks"]
    ep = make_expert_mesh(D, M, device=mesh.device)
    device = ep.model.device
    cfg = spec["cfg"]
    model = get_model(cfg)
    params = init_expert_parallel(
        cfg, ep, torch.Generator(device=device).manual_seed(spec["seed"]), device)
    prompts = torch.as_tensor(spec["prompts"])
    B = prompts.shape[0]
    if B % D:
        raise ValueError(f"{D} data ranks do not divide a batch of {B}")
    d = ep.data.rank
    mine = prompts[d * (B // D):(d + 1) * (B // D)].to(device)
    counts.reset()
    ep.reset_collectives()
    _sync(device)
    t0 = time.perf_counter()
    logits = model.forward(params, {"tokens": mine})
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill = {"launches": counts.snapshot(), "collectives": ep.collective_report()}
    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, params, mine, spec["gen"])
    _sync(device)
    return {
        "data_rank": d, "model_rank": ep.model.rank, "backend": ep.model.backend,
        "tokens": toks.cpu().tolist(), "last_logits": logits[:, -1].float().cpu().numpy(),
        "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0, "prefill": prefill,
    }


def _main_expert_parallel(args, cfg, prompts) -> dict:
    from repro_torch.launch.mesh import spawn_mesh

    D, M = args.data_ranks, args.expert_ranks
    spec = dict(cfg=cfg, seed=args.seed, prompts=prompts.cpu().numpy(), gen=args.gen,
                data_ranks=D, expert_ranks=M)
    ranks = spawn_mesh(serve_expert_parallel, D * M, device=args.device, args=(spec,),
                       libraries=("flash_attention", "flash_attention_wgmma"))
    rows = [r for r in ranks if r["model_rank"] == 0]  # one rank a data row
    toks = torch.tensor([t for r in rows for t in r["tokens"]])
    prefill_s = max(r["prefill_s"] for r in ranks)
    decode_s = max(r["decode_s"] for r in ranks)
    shape = (prompts.shape[0], prompts.shape[1])
    print(f"[serve_lm] {cfg.name} on {D * M} ranks ({D} data x {M} expert, "
          f"{ranks[0]['backend']}): prefill {shape} in {prefill_s:.3f}s "
          f"({shape[0] * shape[1] / prefill_s:.1f} tok/s)")
    print(f"[serve_lm] generated {tuple(toks.shape)} in {decode_s:.1f}s "
          f"({args.batch * args.gen / decode_s:.1f} tok/s)")
    print("[serve_lm] sample:", toks[0, :16].tolist())
    return {"tokens": toks, "prefill_s": prefill_s, "decode_s": decode_s, "ranks": ranks}


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="an arch id or alias (qwen1.5-0.5b, rwkv6-3b, qwen3-moe-235b-a22b, "
                         "pixtral-12b, recurrentgemma-9b, whisper-large-v3, ...)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (reduced widths, f32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to N layers (an encoder-decoder's encoder too), "
                         "every width kept")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; there is no silent "
                         "fallback to the CPU)")
    ap.add_argument("--expert-ranks", type=int, default=0,
                    help="serve an MoE config expert-parallel over M ranks of this host "
                         "(each holds E/M experts; gloo where ranks share a card, NCCL "
                         "with a card a rank); 0: one process")
    ap.add_argument("--data-ranks", type=int, default=1,
                    help="with --expert-ranks: D data ranks, each serving its share of "
                         "the batch (D x M ranks in all)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cut_depth(cfg, args.layers)
    if args.expert_ranks:
        prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (args.batch, args.prompt_len)))
        return _main_expert_parallel(args, cfg, prompts)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    ).to(device)
    batch = prompt_batch(cfg, prompts, args.seed)

    _sync(device)
    t0 = time.perf_counter()
    logits = model.forward(params, batch)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    shape = tuple(logits.shape[:2])  # positions: the patch prefix, then the tokens
    print(f"[serve_lm] {cfg.name} on {device}: prefill {shape} in "
          f"{prefill_s:.3f}s ({shape[0] * shape[1] / prefill_s:.1f} tok/s)")

    t0 = time.perf_counter()
    toks, _ = greedy_decode(model, params, prompts, args.gen, frames=batch.get("frames"))
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"[serve_lm] generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve_lm] sample:", toks[0, :16].tolist())
    return {"logits": logits, "tokens": toks, "prefill_s": prefill_s, "decode_s": dt}


if __name__ == "__main__":
    main()
