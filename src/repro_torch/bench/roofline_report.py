"""Render the roofline table of the port's dry-run JSON (one H100).

The twin of ``benchmarks/roofline_report.py`` for
:mod:`repro_torch.launch.dryrun`'s results: per cell the three terms, the
dominant one, ``mfu%`` (the model FLOPs over the H100's 989 TFLOP/s bf16
peak, divided by the bound: the share of that peak the cell would reach at
its roofline bound), the useful-FLOP ratio, and the arguments' and the
peak estimate's GiB with whether the cell fits the card.  Every number is
a host count over the card's constants, not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.bench.roofline_report dryrun_h100.json
  PYTHONPATH=src python -m repro_torch.bench.roofline_report in.json --md --out report.md
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch.analysis import PEAK_FLOPS


def fmt_s(x):
    if x >= 1:
        return f"{x:7.2f}s "
    return f"{x * 1e3:7.1f}ms"


def render(path: str, md: bool = False):
    with open(path) as f:
        results = json.load(f)
    results.sort(key=lambda r: (r["arch"], r["shape"]))
    sep = "|" if md else " "
    hdr = [
        "arch", "shape", "status", "compute", "memory", "collect",
        "dominant", "mfu%", "useful", "args_GiB", "peak_GiB", "fits",
    ]
    lines = [sep.join(f"{h:>12s}" for h in hdr)]
    if md:
        lines.append(sep.join(["---"] * len(hdr)))
    for r in results:
        if r["status"] != "OK":
            lines.append(
                sep.join(
                    [f"{r['arch']:>12s}", f"{r['shape']:>12s}",
                     f"{r['status']:>12s}",
                     f"{r.get('reason', r.get('traceback', ''))[:60]:>12s}"]
                )
            )
            continue
        rl = r["roofline"]
        mem = r.get("memory", {})
        mfu = 100.0 * rl["model_flops_per_dev"] / PEAK_FLOPS / rl["bound_s"] if rl["bound_s"] else 0
        lines.append(
            sep.join(
                [
                    f"{r['arch']:>12.12s}",
                    f"{r['shape']:>12s}",
                    f"{'OK':>12s}",
                    f"{fmt_s(rl['compute_s']):>12s}",
                    f"{fmt_s(rl['memory_s']):>12s}",
                    f"{fmt_s(rl['collective_s']):>12s}",
                    f"{rl['dominant']:>12s}",
                    f"{mfu:>12.1f}",
                    f"{rl['useful_flop_ratio']:>12.2f}",
                    f"{mem.get('argument_size_b', 0) / 2**30:>12.2f}",
                    f"{mem.get('peak_estimate_b', 0) / 2**30:>12.2f}",
                    f"{str(mem.get('fits', '')):>12s}",
                ]
            )
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.roofline_report")
    ap.add_argument("results", help="dry-run JSON (repro_torch.launch.dryrun --out)")
    ap.add_argument("--md", action="store_true", help="markdown table")
    ap.add_argument("--out", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    table = render(args.results, md=args.md)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
