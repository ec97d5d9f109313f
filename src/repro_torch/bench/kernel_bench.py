"""Kernel micro-bench: each kernel's arithmetic intensity, and on the card
its time.

The port's mirror of ``benchmarks/kernel_bench.py``: the same rows (the
operations and bytes of one call at each shape, the roofline's inputs),
equal to the namesake's.  On a CUDA ``device`` each row also gets ``ms``,
the port kernel's device time of one call at that shape
(:func:`repro_torch.launch.timing.time_ms`): ``batched_degrees`` on random
masks, ``flash_attention`` non-causal in bf16 for one (batch, head), as the
row counts it, and ``wkv6`` in f32 for one (batch, head).  On the CPU no
time is taken: the kernels' plain versions run there, and their time is not
the card's.
"""

from __future__ import annotations

import torch


def rows() -> list:
    """The namesake's rows."""
    out = []
    # bitset degrees: T tasks x n vertices x W words
    for n, T in ((512, 64), (1024, 64)):
        W = (n + 31) // 32
        flops = T * n * W * 3  # and + popcount-adds (SWAR ~3 vector ops/word)
        bytes_moved = (n * W + T * W + T * n * 4) * 4
        out.append(dict(kernel="bitset_degrees", shape=f"n{n}xT{T}", vector_ops=flops,
                        bytes=bytes_moved, intensity=round(flops / bytes_moved, 3)))
    # flash attention: per (B, H) S x S blockwise
    for S, D in ((4096, 128), (32768, 128)):
        flops = 4 * S * S * D  # qk + pv
        bytes_moved = 3 * S * D * 2 + S * D * 2
        out.append(dict(kernel="flash_attention", shape=f"S{S}xD{D}", vector_ops=flops,
                        bytes=bytes_moved, intensity=round(flops / bytes_moved, 1)))
    # wkv6 chunked: per (B, H), T steps, K = V = 64, chunk C
    for T, C in ((4096, 32),):
        K = 64
        flops = T * (3 * C * K + 2 * K * K)  # intra scores + state updates
        bytes_moved = T * (4 * K) * 4 + (K * K) * 4
        out.append(dict(kernel="wkv6", shape=f"T{T}xC{C}", vector_ops=flops,
                        bytes=bytes_moved, intensity=round(flops / bytes_moved, 1)))
    return out


def _call(row: dict, device, gen: torch.Generator):
    """A zero-argument call of the port kernel at ``row``'s shape."""
    from repro_torch.kernels.bitset_ops.kernel import batched_degrees
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.wkv6.kernel import wkv6

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)

    def words(rows: int, W: int):
        bits = torch.randint(-(2**31), 2**31, (rows, W), generator=gen, dtype=torch.int64)
        return bits.to(torch.int32).to(device)

    kind, shape = row["kernel"], row["shape"]
    if kind == "bitset_degrees":
        n, T = (int(x) for x in shape[1:].split("xT"))
        W = (n + 31) // 32
        adj, masks = words(n, W), words(T, W)
        return lambda: batched_degrees(adj, masks)
    if kind == "flash_attention":
        S, D = (int(x) for x in shape[1:].split("xD"))
        q, k, v = (rand(1, S, 1, D, dtype=torch.bfloat16) for _ in range(3))
        return lambda: flash_attention(q, k, v, causal=False)
    T = int(shape[1:].split("xC")[0])
    r, k, v = (rand(1, T, 1, 64) for _ in range(3))
    decay = torch.rand(1, T, 1, 64, generator=gen).to(device) * 0.5 + 0.5
    u = rand(1, 64)
    return lambda: wkv6(r, k, v, decay, u)


def run(csv=True, device="cuda"):
    out = rows()
    if torch.device(device).type == "cuda":
        from repro_torch.launch.timing import time_ms

        gen = torch.Generator().manual_seed(0)
        for row in out:
            row["ms"] = round(time_ms(_call(row, device, gen)), 6)
    if csv:
        keys = list(out[0].keys())
        print(",".join(keys))
        for r in out:
            print(",".join(str(r[k]) for k in keys))
    return out


if __name__ == "__main__":
    run()
