"""Plain PyTorch oracle for the RWKV6 (Finch) WKV recurrence.

The port's twin of ``repro/kernels/wkv6/ref.py``.  Per head with key dim K
and value dim V, state S in R^{K x V}:

    o_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = diag(d_t) S_{t-1} + k_t (x) v_t

with d_t in (0, 1]^K the data-dependent decay.  A loop over time, exact.
"""

from __future__ import annotations

import torch


def wkv6_ref(
    r: torch.Tensor,  # (B, T, H, K) receptance ("query")
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    decay: torch.Tensor,  # (B, T, H, K) in (0, 1] -- d_t
    u: torch.Tensor,  # (H, K) current-token bonus
    initial_state: torch.Tensor | None = None,  # (B, H, K, V)
):
    """Returns (out (B, T, H, V) in r's dtype, final_state (B, H, K, V))."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    S = (
        initial_state
        if initial_state is not None
        else torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    )
    r32, k32, v32, d32 = (t.float() for t in (r, k, v, decay))
    ub = u[None, :, :, None]
    outs = []
    for t in range(T):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r32[:, t], S + ub * kv))
        S = d32[:, t, :, :, None] * S + kv
    out = torch.stack(outs, dim=1) if outs else v32.new_zeros((B, 0, H, V))
    return out.to(r.dtype), S
