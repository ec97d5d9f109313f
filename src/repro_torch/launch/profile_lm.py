"""Where LM serving's time goes on the card, at full width.

  PYTHONPATH=src python -m repro_torch.launch.profile_lm [--arch rwkv6-3b]
  PYTHONPATH=src python -m repro_torch.launch.profile_lm --arch qwen3-moe-235b-a22b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_lm --arch recurrentgemma-9b --prompt-len 4096
  PYTHONPATH=src python -m repro_torch.launch.profile_lm --arch whisper-large-v3 --prompt-len 448

Builds the arch at full width in bf16 with the port's seeded init (``--layers
N`` cuts depth, every width kept), warms up, then runs under
``torch.profiler`` one prefill of ``--batch`` prompts of ``--prompt-len``
tokens (a VLM's after its seeded patch prefix, an encoder-decoder's over its
seeded frames) and ``--steps`` greedy decode steps after the prompt: rwkv6's
state comes from one multi-token ``decode_fn`` over it; the transformer's,
Griffin's and the encoder-decoder's caches are only set to the prompt's
length (a step attends over the whole cache buffer or window ring whatever
it holds, so its cost does not depend on the values; the encoder-decoder's
cross K/V are primed from the frames first).  Prints, for the prefill and
for the decode steps:

* wall time, device busy time (the union of kernel, copy and memset
  intervals in the trace), the device's idle share, and device events and
  host ops (the trace's ``cpu_op`` events) per step;
* device time and launch count by kernel name, largest first;
* for MoE, the MoE layers' device time split by their profiler ranges
  (``moe.route``: router, softmax, top-k, the sort and positions;
  ``moe.dispatch``; ``moe.experts``: the three ``bmm`` and the SwiGLU;
  ``moe.combine``), and for Griffin the RG-LRU's (``griffin.rglru``: the
  gates' f32 arithmetic and the scan), each device event given to the range
  its launch was issued in (``launch/profile.py``'s ``range_split``; the
  ranges are :mod:`repro_torch.telemetry` spans, which the profiler switches
  on);
* the hand-written kernels' launches.

The traces go to ``--trace-dir`` (default ``build/repro_torch_profile/``).
Runs under ``torch.inference_mode()``, as serving does.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.launch.profile import _device_intervals, _union_us, range_split
from repro_torch.launch.serve_lm import cut_depth, prompt_batch
from repro_torch.models import encdec
from repro_torch.models.registry import get_model

MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
GRIFFIN_RANGES = ("griffin.rglru",)


def _ranges(cfg) -> tuple:
    """The profiler ranges a model's layers open, by family."""
    if cfg.is_moe:
        return MOE_RANGES
    return GRIFFIN_RANGES if cfg.family == "hybrid" else ()


def _print_split(label: str, split: dict, per: int, ranges: tuple) -> None:
    total = sum(split.values()) or 1.0
    ranged = sum(split.get(n, 0.0) for n in ranges) or 1.0
    print(f"[profile_lm] {label}: device time by profiler range (ms per step, share of the "
          f"ranges, share of all device time):")
    for name in (*ranges, "other"):
        v = split.get(name, 0.0)
        print(f"[profile_lm]   {name:14s} {v / per:10.3f}  "
              f"{(v / ranged if name != 'other' else float('nan')):6.3f}  {v / total:6.3f}")


def _report(label: str, prof, trace: Path, wall_s: float, top: int, per: int) -> None:
    prof.export_chrome_trace(str(trace))
    intervals = _device_intervals(trace)
    busy_s = _union_us(intervals) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in intervals:
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
    total_ms = sum(v[0] for v in by_name.values()) or 1.0
    events = json.loads(trace.read_text())["traceEvents"]
    host_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    print(f"[profile_lm] {label}: wall {wall_s:.6f} s (under the profiler), device busy "
          f"{busy_s:.6f} s, idle share {1 - busy_s / wall_s:.3f}, device events "
          f"{len(intervals)} ({len(intervals) / per:.1f} per step), host ops (cpu_op "
          f"events, nested included) {host_ops / per:.1f} per step")
    print(f"[profile_lm] {label}: device time by kernel (ms, share, count):")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile_lm]   {ms:10.3f}  {ms / total_ms:6.3f}  {cnt:7d}  {name[:100]}")


@torch.inference_mode()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to N layers (an encoder-decoder's encoder too), "
                         "every width kept")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8, help="profiled decode steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", default="build/repro_torch_profile")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("profile_lm: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = cut_depth(get_config(args.arch), args.layers)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    B, P = args.batch, args.prompt_len
    toks = torch.from_numpy(
        np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, P))).to(dev)
    batch = prompt_batch(cfg, toks, args.seed)
    ranges = _ranges(cfg)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    print(f"[profile_lm] {torch.cuda.get_device_name(0)}; {cfg.name} bf16, {cfg.n_layers} "
          f"layers, {sum(p.numel() for p in params.parameters())} params, B={B}, P={P}"
          + (f" after {cfg.n_patches} patches" if cfg.family == "vlm" else ""))

    model.forward(params, batch)  # warm-up
    torch.cuda.synchronize()
    counts.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"[profile_lm] prefill launches {counts.snapshot()}")
    trace = trace_dir / f"{cfg.name}_prefill.json"
    _report("prefill", prof, trace, wall_s, args.top, 1)
    if ranges:
        _print_split("prefill", range_split(trace, ranges), 1, ranges)

    # a cache holding the prompt, then greedy steps
    cache = model.init_decode_cache(B, P + args.steps + 2, device=dev)
    if cfg.family == "ssm":
        logits, cache = model.decode_fn(params, cache, toks)
    else:
        if cfg.family == "encdec":
            cache = encdec.prime_cross_cache(params, cache, batch["frames"])
        cache["len"] = P
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    logits, cache = model.decode_fn(params, cache, tok)  # warm-up step
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    counts.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            logits, cache = model.decode_fn(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"[profile_lm] decode launches {counts.snapshot()}; "
          f"{1e3 * wall_s / args.steps:.3f} ms a step under the profiler")
    trace = trace_dir / f"{cfg.name}_decode.json"
    _report(f"{args.steps} decode steps", prof, trace, wall_s, args.top, args.steps)
    if ranges:
        _print_split(f"{args.steps} decode steps", range_split(trace, ranges), args.steps,
                     ranges)


if __name__ == "__main__":
    main()
