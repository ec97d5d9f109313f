"""Plain PyTorch oracle for blockwise (flash) attention.

The port's twin of ``repro/kernels/flash_attention/ref.py``: causal and
sliding-window masks, GQA (the oracle repeats each KV head over its group
of query heads), queries at the end of the key timeline.  The (S, S) score
matrix is materialized, so it is for test sizes only.  Masked scores are
``-inf`` and fully masked rows become zeros through ``nan_to_num``, as in the
JAX oracle (the blockwise paths use ``-1e30`` instead).
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,  # sliding window size (None = global)
) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)

    kr = k.repeat_interleave(G, dim=2)  # (B, Sk, Hq, D)
    vr = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale  # (B, Hq, Sq, Sk)

    # queries occupy the LAST Sq slots of the Sk timeline (decode: Sq = 1
    # attends to the whole cache causally)
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask[None, None], logits, float("-inf"))

    probs = torch.nan_to_num(torch.exp(logits - logits.amax(-1, keepdim=True)))
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    return out.to(q.dtype)
