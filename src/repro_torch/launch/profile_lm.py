"""Where LM serving's time goes on the card, at full width.

  PYTHONPATH=src python -m repro_torch.launch.profile_lm [--arch rwkv6-3b]

Builds the arch at full width in bf16 with the port's seeded init, warms up,
then runs under ``torch.profiler`` one prefill of ``--batch`` prompts of
``--prompt-len`` tokens and ``--steps`` greedy decode steps after the
prompt: rwkv6's state comes from one multi-token ``decode_fn`` over it; the
dense cache is only set to the prompt's length (a step attends over the
whole cache buffer whatever it holds, so its cost does not depend on the
values).  Prints, for the prefill and for the decode steps:

* wall time, device busy time (the union of kernel, copy and memset
  intervals in the trace), the device's idle share, and device events and
  host ops (the trace's ``cpu_op`` events) per step;
* device time and launch count by kernel name, largest first;
* the hand-written kernels' launches.

The traces go to ``--trace-dir`` (default ``build/repro_torch_profile/``).
Needs a CUDA device.
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
from repro_torch.launch.profile import _device_intervals, _union_us
from repro_torch.models.registry import get_model


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
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
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    B, P = args.batch, args.prompt_len
    toks = torch.from_numpy(
        np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, P))).to(dev)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    print(f"[profile_lm] {torch.cuda.get_device_name(0)}; {cfg.name} bf16, "
          f"{sum(p.numel() for p in params.parameters())} params, B={B}, P={P}")

    model.forward(params, {"tokens": toks})  # warm-up
    torch.cuda.synchronize()
    counts.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"[profile_lm] prefill launches {counts.snapshot()}")
    _report("prefill", prof, trace_dir / f"{cfg.name}_prefill.json", wall_s, args.top, 1)

    # a cache holding the prompt, then greedy steps
    cache = model.init_decode_cache(B, P + args.steps + 2, device=dev)
    if cfg.family == "ssm":
        logits, cache = model.decode_fn(params, cache, toks)
    else:
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
    _report(f"{args.steps} decode steps", prof, trace_dir / f"{cfg.name}_decode.json",
            wall_s, args.top, args.steps)


if __name__ == "__main__":
    main()
