"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Start it from the root of a checkout.  It loads the port from ``src/``,
keeps every build and kernel cache inside the checkout, measures for
``--seconds`` after set-up, checks what the window produced against the
plain reference, and prints one JSON line last on standard output, with
each number compared and its limit last on standard error.  It exits 3 and
prints no result without the CUDA devices the cell asks for, and 4 if JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import bench

    try:
        line, checks = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                 T_START)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 3
    return bench.print_result(line, checks)


if __name__ == "__main__":
    sys.exit(main())
