"""Mixture-of-Experts block, for serving: top-k routing with sort-based
grouped dispatch.

The port of ``repro/models/moe.py``: ``moe_init`` as the ``MoE`` module and
``_moe_gspmd`` with one group (G = 1, what ``num_groups(None)`` gives and the
only route of the JAX serving path, which passes ``rules=None``) as
``moe_apply``.  Every rounding point and index rule is kept:

1. the router in f32 (``x.float() @ router``; the router weight stays f32 in
   a bf16 model), softmax, top-k, the K probabilities renormalised with a
   1e-9 floor; the Switch aux loss over the T·K assignments;
2. the flat assignments ``t·K + k`` sorted by expert with a stable argsort,
   each one's position within its expert from a left searchsorted segment
   start; the capacity is JAX's floor ``C = int(max(1, (K·T/E)·cf))``, and an
   assignment at a position ≥ C drops (its token keeps the residual only);
3. the kept assignments gathered into the (E·C, d) expert batch in x's dtype
   (a dropped one lands on a discard row), the expert SwiGLU as three
   ``torch.bmm`` over E;
4. the combine: each kept output times its router weight, cast to x's dtype
   first, summed per token in x's dtype in ascending expert order: the order
   in which JAX's CPU scatter applies its sorted updates.  There is no
   ``index_add_``: CUDA's atomic adds in bf16 would make the logits differ
   from run to run.

No step waits for the host: C comes from shapes, no boolean mask indexes a
tensor, and nothing calls ``.item()``.  The four steps run under the
profiler ranges ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (``launch/profile_lm.py`` splits the layer's device time by
them).

Not ported: ``_moe_shard_map``, the expert parallelism over a JAX mesh,
which the JAX package selects only with ``rules["_moe_impl"]`` and a mesh; it
needs an LM that spans several cards (ROADMAP queue 1).  Neither package has
a hand-written kernel here: the expert products are plain matrix products.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class MoE(nn.Module):
    """router (d, E) in f32; w1 gate, w3 up (E, d, f) and w2 down (E, f, d)
    in the config's dtype."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = L.torch_dtype(cfg)
        self.router = L.param((d, E), torch.float32, std=d**-0.5, generator=generator,
                              device=device)
        self.w1 = L.param((E, d, f), dt, std=d**-0.5, generator=generator, device=device)
        self.w3 = L.param((E, d, f), dt, std=d**-0.5, generator=generator, device=device)
        self.w2 = L.param((E, f, d), dt, std=f**-0.5, generator=generator, device=device)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: JAX's floor (``repro/models/moe.py:129``)."""
    return int(max(1, (cfg.top_k * T / cfg.n_experts) * cfg.capacity_factor))


def route(cfg: ModelConfig, p, x: torch.Tensor) -> dict:
    """The routing of x (B, S, d), tokens flattened to T = B·S:

    * ``probs`` (T, E), ``top_e`` and ``top_p`` (T, K), renormalised;
    * ``order`` (A,), A = T·K: the stable sort of the flat assignments by
      expert; ``st`` and ``sp``: their token and weight in that order;
      ``keep``: their position within the expert is under C;
    * ``slot``: the row of the (E·C, d) expert batch, E·C when dropped;
    * ``counts`` (E,): assignments per expert, ``C``, and ``aux``.

    The router runs in f32, or in x's dtype where that is wider (an f64
    reference of the same op)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T, A = B * S, B * S * K
    rdt = torch.promote_types(x.dtype, torch.float32)
    logits = x.reshape(T, d).to(rdt) @ p.router.to(rdt)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    order = torch.argsort(top_e.reshape(A), stable=True)
    se = top_e.reshape(A)[order]
    st = order // K  # the flat assignment t·K + k belongs to token t
    sp = top_p.reshape(A)[order]
    experts = torch.arange(E, device=x.device, dtype=se.dtype)
    seg_start = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - seg_start
    C = capacity(cfg, T)
    pos = torch.arange(A, device=x.device) - seg_start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    # Switch aux loss: E * sum_e (fraction routed to e) * (mean prob of e)
    aux = E * torch.sum(counts.to(rdt) / (T * K) * probs.mean(0))
    return dict(probs=probs, top_e=top_e, top_p=top_p, order=order, st=st, sp=sp,
                keep=keep, slot=slot, counts=counts, C=C, aux=aux)


def keep_by_token(r: dict) -> torch.Tensor:
    """``r["keep"]`` back in the flat order: (T, K), entry (t, k) for token
    t's k-th choice ``top_e[t, k]``."""
    keep = torch.empty_like(r["keep"])
    keep[r["order"]] = r["keep"]
    return keep.view(r["top_e"].shape)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss ()).  ``p`` is
    an ``MoE`` or anything with its four weights."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    with record_function("moe.route"):
        r = route(cfg, p, x)
    C = r["C"]
    with record_function("moe.dispatch"):
        buf = x.new_zeros((E * C + 1, d))  # the last row takes the dropped
        buf[r["slot"]] = x.reshape(T, d)[r["st"]]
        xe = buf[: E * C].view(E, C, d)
    with record_function("moe.experts"):
        h = F.silu(torch.bmm(xe, p.w1)) * torch.bmm(xe, p.w3)
        y = torch.bmm(h, p.w2).view(E * C, d)
    with record_function("moe.combine"):
        contrib = y[r["slot"].clamp(max=E * C - 1)] * r["sp"].to(x.dtype)[:, None]
        contrib = torch.where(r["keep"][:, None], contrib, contrib.new_zeros(()))
        # each token's K rows of the sorted order, ascending: its experts in
        # ascending order, added one by one in x's dtype
        rank = torch.empty_like(r["order"])
        rank[r["order"]] = torch.arange(T * K, device=x.device)
        rows = rank.view(T, K).sort(dim=-1).values
        out = contrib[rows[:, 0]]
        for k in range(1, K):
            out = out + contrib[rows[:, k]]
    return out.view(B, S, d), r["aux"]
