"""Paper §4.3: bytes-per-task for the two serialization schemes.

The port's mirror of ``benchmarks/encoding_bytes.py``: the same rows, which
``benchmarks/baseline.json`` pins exactly.

basic     = (n+2)·W + 1 words  (adjacency rows travel with the task)
optimized = 2·W + 1 words      (n-bit mask of surviving vertices)

The table shows why the centralized scheduler collapses under the basic
encoding (every task crosses the wire twice) and why the optimized encoding
is what makes a fixed-shape device frontier natural.

The trailing columns extend the story to the SPMD data plane at P=64
(EXPERIMENTS.md §Perf): the gather path all-gathers the full P-row record
table every transfer round, while the sparse masked-psum path pays only for
the records that actually matched (here m=1 match — the common case late in
a run; 0 matches moves 0 bytes).
"""

from __future__ import annotations

from repro_torch.core.encoding import make_codec

P_REF = 64  # reference worker count for the per-round wire columns


def run(csv=True):
    rows = []
    for n in (128, 500, 700, 1000, 4096):
        opt = make_codec("optimized", n)
        bas = make_codec("basic", n)
        rows.append(
            dict(
                n=n,
                optimized_bytes=opt.record_bytes,
                basic_bytes=bas.record_bytes,
                ratio=round(bas.record_bytes / opt.record_bytes, 1),
                gather_round_B_p64=P_REF * opt.record_bytes,
                sparse_round_B_m1=opt.record_bytes,
            )
        )
    if csv:
        keys = list(rows[0].keys())
        print(",".join(keys))
        for r in rows:
            print(",".join(str(r[k]) for k in keys))
    # dict form, so repro_torch.bench.run records it and checks its pins
    return {"P_ref": P_REF, "rows": rows}


if __name__ == "__main__":
    run()
