"""Public entry points of the WKV6 recurrence.

The port of ``repro/kernels/wkv6/ops.py``.  ``wkv6_op`` defaults to the
hand-written kernel, where the JAX package defaults to ``"ref"`` (on the
TPU no entry point ever selected ``"pallas"``); ``"ref"`` stays as the named
plain version.  The kernel runs the recurrence in time order, so the JAX
wrapper's padding of T to a chunk multiple is gone.  ``wkv6_decode_step``
is the single-token form of the decode path (plain torch, as in the JAX
package).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6_op(r, k, v, decay, u, initial_state=None, *, impl: str = "kernel"):
    """(B, T, H, K/V) inputs -> (out, final_state).  impl: 'kernel' | 'ref'."""
    if impl == "kernel":
        return wkv6(r, k, v, decay, u, initial_state)
    if impl == "ref":
        return wkv6_ref(r, k, v, decay, u, initial_state)
    raise ValueError(f"unknown wkv6 impl {impl!r}; known: kernel, ref")


def wkv6_decode_step(r_t, k_t, v_t, d_t, u, state):
    """One decode token: r_t/k_t/d_t (B, H, K), v_t (B, H, V),
    state (B, H, K, V) -> (o_t (B, H, V), new_state)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r_t, state + u[None, :, :, None] * kv)
    new_state = d_t[..., :, None] * state + kv
    return o, new_state
