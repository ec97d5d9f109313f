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
telemetry spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (:mod:`repro_torch.telemetry`: profiler ranges while a
profiler runs, one check otherwise; ``launch/profile_lm.py`` splits the
layer's device time by them).

``moe_apply_ep`` is the port of ``_moe_shard_map``, the expert parallelism
JAX selects with ``rules["_moe_impl"] == "shard_map"`` and a mesh: each rank
of a (data, model) grid of ``torch.distributed`` ranks
(:class:`~repro_torch.launch.mesh.ExpertMesh`) holds E/M experts, routes its
own tokens with JAX's ceiling capacity, runs the assignments that hit its
experts, and one SUM over the model ranks gives the output.  An ``MoE``
whose ``ep`` is set takes it (:func:`attach_expert_mesh`); it serves
(prefill and decode) and trains: its collectives carry JAX's transposes
under autograd (``SolverMesh.psum``/``pvary``/``invariant``), so each rank's
backward gives the gradient of the whole layer (``launch/train.py``
averages it over the data ranks).  Neither package has a hand-written
kernel here: the expert products are plain matrix products.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.telemetry import span


class MoE(nn.Module):
    """router (d, E) in f32; w1 gate, w3 up (E, d, f) and w2 down (E, f, d)
    in the config's dtype.

    ``experts=(lo, hi)`` keeps experts [lo, hi) of the bank, the slice an
    expert-parallel rank holds: every weight is drawn whole from
    ``generator`` (so the numbers equal the whole bank's) and sliced.  ``ep``
    is the rank's :class:`~repro_torch.launch.mesh.ExpertMesh` once
    :func:`attach_expert_mesh` sets it; None, the one-card route."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None, experts=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = L.torch_dtype(cfg)
        lo, hi = experts or (0, E)

        def bank(shape, std):
            w = L.param(shape, dt, std=std, generator=generator, device=device)
            return w if (lo, hi) == (0, E) else nn.Parameter(w.detach()[lo:hi].clone())

        self.router = L.param((d, E), torch.float32, std=d**-0.5, generator=generator,
                              device=device)
        self.w1 = bank((E, d, f), d**-0.5)
        self.w3 = bank((E, d, f), d**-0.5)
        self.w2 = bank((E, f, d), f**-0.5)
        self.ep = None


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: JAX's floor (``repro/models/moe.py:129``)."""
    return int(max(1, (cfg.top_k * T / cfg.n_experts) * cfg.capacity_factor))


def ep_capacity(cfg: ModelConfig, Tg: int) -> int:
    """Slots per expert for a data rank's Tg tokens on the expert-parallel
    route: JAX's ceiling (``repro/models/moe.py:195``), not the floor of the
    one-card route (ROADMAP §3)."""
    K, E = cfg.top_k, cfg.n_experts
    return int(max(1, -(-K * Tg * cfg.capacity_factor // E)))


def expert_range(n_experts: int, rank: int, ranks: int) -> tuple:
    """Experts [lo, hi) of model rank ``rank`` of ``ranks`` on the
    expert-parallel route; ``ValueError`` when the ranks do not divide the
    experts."""
    if n_experts % ranks:
        raise ValueError(f"{ranks} model ranks do not divide {n_experts} experts")
    per = n_experts // ranks
    return rank * per, (rank + 1) * per


def route(cfg: ModelConfig, p, x: torch.Tensor, C: int | None = None, router=None) -> dict:
    """The routing of x (B, S, d), tokens flattened to T = B·S:

    * ``probs`` (T, E), ``top_e`` and ``top_p`` (T, K), renormalised;
    * ``order`` (A,), A = T·K: the stable sort of the flat assignments by
      expert; ``st`` and ``sp``: their token and weight in that order;
      ``keep``: their position within the expert is under C;
    * ``slot``: the row of the (E·C, d) expert batch, E·C when dropped;
    * ``counts`` (E,): assignments per expert, ``C``, and ``aux``.

    ``C`` defaults to :func:`capacity`, ``router`` to ``p.router``.  The
    router runs in f32, or in x's dtype where that is wider (an f64
    reference of the same op)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T, A = B * S, B * S * K
    rdt = torch.promote_types(x.dtype, torch.float32)
    router = p.router if router is None else router
    logits = x.reshape(T, d).to(rdt) @ router.to(rdt)
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
    C = capacity(cfg, T) if C is None else C
    pos = torch.arange(A, device=x.device) - seg_start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    # Switch aux loss: E * sum_e (fraction routed to e) * (mean prob of e)
    aux = E * torch.sum(counts.to(rdt) / (T * K) * probs.mean(0))
    return dict(probs=probs, top_e=top_e, top_p=top_p, order=order, se=se, st=st, sp=sp,
                pos=pos, keep=keep, slot=slot, counts=counts, C=C, aux=aux)


def keep_by_token(r: dict) -> torch.Tensor:
    """``r["keep"]`` back in the flat order: (T, K), entry (t, k) for token
    t's k-th choice ``top_e[t, k]``."""
    keep = torch.empty_like(r["keep"])
    keep[r["order"]] = r["keep"]
    return keep.view(r["top_e"].shape)


def _experts(p, x: torch.Tensor, r: dict, slot, keep, n_rows: int):
    """Dispatch, the expert SwiGLU over the bank ``p`` holds and the
    combine: x's tokens at their kept ``slot`` rows of an (n_rows, d) batch
    (``slot`` == n_rows drops), -> (T, d) in x's dtype."""
    B, S, d = x.shape
    T, K = B * S, r["top_e"].shape[1]
    n_exp = p.w1.shape[0]
    with span("moe.dispatch", x.device):
        buf = x.new_zeros((n_rows + 1, d))  # the last row takes the dropped
        # the gather as an embedding lookup: its gradient adds each token's K
        # copies in a fixed order (an index expression's scatters them with
        # atomic adds on the card, which vary from run to run)
        buf[slot] = F.embedding(r["st"], x.reshape(T, d))
        xe = buf[:n_rows].view(n_exp, n_rows // n_exp, d)
    with span("moe.experts", x.device):
        h = F.silu(torch.bmm(xe, p.w1)) * torch.bmm(xe, p.w3)
        y = torch.bmm(h, p.w2).view(n_rows, d)
    with span("moe.combine", x.device):
        contrib = y[slot.clamp(max=n_rows - 1)] * r["sp"].to(x.dtype)[:, None]
        contrib = torch.where(keep[:, None], contrib, contrib.new_zeros(()))
        # each token's K rows of the sorted order, ascending: its experts in
        # ascending order, added one by one in x's dtype
        rank = torch.empty_like(r["order"])
        rank[r["order"]] = torch.arange(T * K, device=x.device)
        rows = rank.view(T, K).sort(dim=-1).values
        out = contrib[rows[:, 0]]
        for k in range(1, K):
            out = out + contrib[rows[:, k]]
    return out


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss ()).  ``p`` is
    an ``MoE`` or anything with its four weights; an ``MoE`` with an
    expert mesh (``p.ep``) takes the expert-parallel route
    (:func:`moe_apply_ep`), as JAX's dispatch takes ``_moe_shard_map``."""
    if getattr(p, "ep", None) is not None:
        return moe_apply_ep(cfg, p, x, p.ep)
    B, S, d = x.shape
    with span("moe.route", x.device):
        r = route(cfg, p, x)
    out = _experts(p, x, r, r["slot"], r["keep"], cfg.n_experts * r["C"])
    return out.view(B, S, d), r["aux"]


def moe_apply_ep(cfg: ModelConfig, p, x: torch.Tensor, ep):
    """The expert-parallel route, JAX's ``_moe_shard_map``
    (``repro/models/moe.py:167-261``), on one rank of ``ep``'s (data D,
    model M) grid: x (B, S, d) is this data rank's tokens (Tg = B·S), ``p``
    holds model rank m's experts [m·E/M, (m+1)·E/M) and the whole router
    (JAX all-gathers a sharded router: the same numbers).

    The rank routes its tokens with the capacity ``ep_capacity(Tg)``, keeps
    the assignments that hit its experts, runs them as an (E/M, C, d)
    batch and adds their weighted outputs per token in ascending expert
    order; one SUM over the model ranks gives the output.  The aux loss
    uses the expert counts summed and the mean probabilities averaged over
    the data ranks, of all T = D·Tg tokens, as at ``:209-217`` (the same on
    every model rank).

    Under autograd the collectives carry JAX's transposes: the output's SUM
    (``psum``) passes its cotangent through; x and the router enter as
    values every model rank holds whole (``pvary``: x's replicated in_spec
    at ``:252``, the router's gather at ``:201``), so the backward sums
    each rank's part of their gradients over the model ranks; the aux loss,
    computed equal on every model rank, has its cotangent divided by M
    (``invariant``: JAX's ``pmean(aux, model)`` at ``:218``), so that sum
    counts it once; the data mean of the probabilities passes its cotangent
    through (``pmean``: the data ranks' gradients are averaged after the
    backward).  The counts carry no gradient.  E % M != 0 raises
    ``ValueError``: JAX drops back to its gspmd route there, which a rank
    holding E/M experts cannot run."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    M, D = ep.model.size, ep.data.size
    if E % M:
        raise ValueError(f"expert parallelism needs the model ranks to divide the experts: "
                         f"E={E}, M={M} (JAX's _moe_shard_map drops back to gspmd there)")
    Tg = B * S
    E_loc = E // M
    if p.w1.shape[0] != E_loc:
        raise ValueError(f"model rank {ep.model.rank} of {M} holds {p.w1.shape[0]} experts, "
                         f"not E/M = {E_loc}")
    x = ep.model.pvary(x)
    with span("moe.route", x.device):
        r = route(cfg, p, x, C=ep_capacity(cfg, Tg), router=ep.model.pvary(p.router))
        C = r["C"]
        counts = ep.data.all_sum(r["counts"].to(r["probs"].dtype))
        pmean = ep.data.pmean(r["probs"].mean(0))
        aux = ep.model.invariant(E * torch.sum(counts / (D * Tg * K) * pmean))
        rel = r["se"] - ep.model.rank * E_loc
        mine = r["keep"] & (rel >= 0) & (rel < E_loc)
        slot = torch.where(mine, rel * C + r["pos"], E_loc * C)
    out = _experts(p, x, r, slot, mine, E_loc * C)
    with span("moe.collective", x.device):
        out = ep.model.psum(out)
    return out.view(B, S, d), aux


def attach_expert_mesh(model: nn.Module, ep) -> nn.Module:
    """Route every MoE layer of ``model`` (whose banks hold model rank
    ``ep.model.rank``'s E/M experts) through ``ep``: the expert-parallel
    route."""
    for m in model.modules():
        if isinstance(m, MoE):
            m.ep = ep
    return model
