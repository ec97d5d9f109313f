"""The meta route of the LM kernels: what a dry run sees in place of a launch.

A ``meta`` tensor has a shape and a dtype and no storage; the dry run
(:mod:`repro_torch.launch.dryrun`) builds a whole step from them to count
its FLOPs and bytes without a card.  Neither kernel launches on one:

* ``flash_attention`` runs its plain version over the whole key range as
  one block, so a FLOP counter counts its products, masked pairs included,
  as XLA's cost analysis counts the JAX package's attention;
* ``wkv6`` returns outputs of the right shapes and adds its FLOPs by
  formula (5 a (b, t, h, k, v) forward, 12 backward), so the plain
  version's Python loop over T is never traced.

Each route runs under :func:`fused`, which records the kernel's own bytes
(each input read once, each output written once) and FLOPs by formula where
a counter cannot see them; an accountant of aten ops skips what runs inside
(:func:`inside`), as the kernel keeps it on chip.  Only ``meta`` takes
these routes: a CPU tensor keeps the plain version and a CUDA tensor the
kernel.  Nothing launches here, so the launch counts are untouched.
"""

from __future__ import annotations

import contextlib

_DEPTH = [0]

# name -> {"calls", "bytes", "flops"}: what the meta routes recorded
RECORDS: dict[str, dict] = {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def inside() -> bool:
    """True while a meta route runs: its aten ops are the kernel's inside."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def fused(name: str, inputs, flops: float = 0.0):
    """Run a meta route as one kernel: yields a list the route appends its
    outputs to; on exit ``name`` records a call, the bytes of ``inputs``
    and of those outputs, and ``flops`` (the formula's, 0 where an aten
    FLOP counter sees the products)."""
    outputs: list = []
    _DEPTH[0] += 1
    try:
        yield outputs
    finally:
        _DEPTH[0] -= 1
    rec = RECORDS.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0.0})
    rec["calls"] += 1
    rec["bytes"] += nbytes(*inputs) + nbytes(*outputs)
    rec["flops"] += flops


def reset() -> None:
    RECORDS.clear()


def snapshot() -> dict:
    return {k: dict(v) for k, v in RECORDS.items()}
