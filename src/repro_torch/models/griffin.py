"""Griffin-style hybrid (recurrentgemma): RG-LRU recurrent blocks and local
attention, tiled in the config's ``pattern`` (recurrentgemma: rec, rec, attn).

The port of ``repro/models/griffin.py``: ``RecBlock``, ``causal_conv``,
``rglru``, ``rec_apply``, the group plan, ``init_lm``, ``forward``,
``loss_fn``, ``init_decode_cache`` and ``decode_fn`` with its ring-buffer
window attention.  ``forward`` builds a graph when grad mode is on, each full
unit rematerialised (``layers.remat``) and the tail not, as JAX checkpoints
its scanned groups; serving calls it under ``torch.inference_mode()``.  Λ is
trained, as in JAX.  JAX scans ``n_groups`` full pattern units and runs the
remainder (the tail) unscanned; here ``groups`` and ``tail`` are
``nn.ModuleList``s of units, each unit's layers in ``sub`` (the JAX tree's
names: ``groups.{g}.sub.{j}``, ``tail.{t}.sub.0``).  Like JAX's init, a
config with no full unit still holds one (unused) group.

RG-LRU (arXiv:2402.19427 eq. 3-4), in f32:
    r_t = σ(W_a x_t + b_a);  i_t = σ(W_x x_t + b_x)
    a_t = exp(c · r_t · (−softplus(Λ)))          (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

JAX runs the recurrence with ``jax.lax.associative_scan``; ``linear_scan``
runs it as a Hillis–Steele scan over (a, b) pairs in plain torch, ceil(log2
T) doublings (12 at T 4,096), where a loop over time would be T steps of
launches.  The two orders of association differ in the last f32 bits.  A
single token against a state takes the step ``a h + b``, as in JAX.  Under
autograd each doubling writes a new tensor (autograd refuses an in-place
write into a tensor it saved); without it the doublings write in place.

The forward's local attention goes through ``attention_apply(causal=True,
window=cfg.window)`` and so, with ``attn_impl="kernel"``, one
``flash_attention`` launch per attention layer on the card (at D 256 in
bf16 on the tensor cores).  Decode attends over the ring in plain torch, as
JAX's is plain jnp, and launches no kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.telemetry import span

LRU_C = 8.0


def lru_lambda(d_rnn: int, device=None) -> torch.Tensor:
    """Λ by JAX's init's formula, a ≈ uniform(0.9, 0.999) at r = 1: computed
    in f64 and rounded once to f32.  JAX computes it in f32, whose last bit
    of a near 0.999 moves Λ by up to ~6e-5."""
    a = torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float64, device=device)
    return torch.log(torch.expm1(-torch.log(a) / LRU_C)).float()


class RecBlock(nn.Module):
    """w_gate, w_in (d, dr), conv (CW, dr), w_a, w_x (dr, dr), w_out (dr, d)
    in the model's dtype; b_a, b_x and lam in f32, as JAX makes them."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
        dt = L.torch_dtype(cfg)
        f32 = torch.float32
        self.w_gate = L.dense(d, dr, dt, generator, device)
        self.w_in = L.dense(d, dr, dt, generator, device)
        self.conv = L.param((cfg.conv_width, dr), dt, std=0.1, generator=generator,
                            device=device)
        self.w_a = L.dense(dr, dr, dt, generator, device)
        self.b_a = L.param((dr,), f32, fill=0.0, device=device)
        self.w_x = L.dense(dr, dr, dt, generator, device)
        self.b_x = L.param((dr,), f32, fill=0.0, device=device)
        self.lam = nn.Parameter(lru_lambda(dr, device))
        self.w_out = L.dense(dr, d, dt, generator, device)


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv over time: x (B, T, dr), w (CW, dr), state (B,
    CW-1, dr) the previous inputs' tail.  -> (out, the new tail); products
    and sums in x's dtype, as JAX's ``sum`` of shifted products."""
    CW = w.shape[0]
    prev = (x.new_zeros((x.shape[0], CW - 1, x.shape[2])) if state is None
            else state.to(x.dtype))
    xp = torch.cat([prev, x], dim=1)  # (B, T+CW-1, dr)
    T = x.shape[1]
    out = 0
    for i in range(CW):
        out = out + xp[:, i : i + T] * w[i]
    return out, xp[:, -(CW - 1) :]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1: the Hillis–Steele
    scan of the pairs (a, b) under (a1, b1) ∘ (a2, b2) = (a1 a2, b1 a2 + b2),
    JAX's ``combine``, in ceil(log2 T) doublings; the same values in place
    or, when a gradient is to be taken, out of place."""
    T, d = a.shape[1], 1
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        h = b
        while d < T:
            h = torch.cat([h[:, :d], h[:, :-d] * a[:, d:] + h[:, d:]], dim=1)
            if 2 * d < T:
                a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
            d *= 2
        return h
    a, h = a.clone(), b.clone()
    while d < T:
        h[:, d:] = h[:, :-d] * a[:, d:] + h[:, d:]  # the right side is read whole first
        if 2 * d < T:
            a[:, d:] = a[:, :-d] * a[:, d:]
        d *= 2
    return h


def rglru(x, r, i, lam, h0: torch.Tensor | None = None):
    """x, r, i (B, T, dr); lam (dr,) f32; h0 (B, dr) f32 or None.
    -> (y (B, T, dr) in x's dtype, h_T (B, dr) f32)."""
    log_a = -LRU_C * F.softplus(lam) * r.float()  # <= 0
    a = torch.exp(log_a)
    gated = (i * x).float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) * gated
    if x.shape[1] == 1 and h0 is not None:  # decode fast path
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rec_apply(cfg: ModelConfig, p: RecBlock, x: torch.Tensor, *, state: dict | None = None):
    """The recurrent temporal block.  state = dict(h, conv) or None ->
    (out (B, T, d), the new state).  The biases and the RG-LRU are f32, so r
    and i are f32 as JAX promotes them."""
    st = state or {}
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    u = x @ p.w_in
    u, conv_state = causal_conv(u, p.conv, st.get("conv"))
    r = torch.sigmoid(u @ p.w_a + p.b_a)
    i = torch.sigmoid(u @ p.w_x + p.b_x)
    with span("griffin.rglru", u.device):
        y, h = rglru(u, r, i, p.lam, st.get("h"))
    return (y * gate) @ p.w_out, {"h": h, "conv": conv_state}


# -- block stack -------------------------------------------------------------------


class Sub(nn.Module):
    """One layer of a unit: ln1, its temporal block (``RecBlock`` or
    ``Attention``), ln2 and a GELU MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, generator=None, device=None):
        super().__init__()
        self.ln1 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.temporal = (RecBlock(cfg, generator, device) if kind == "rec"
                         else L.Attention(cfg, generator, device))
        self.ln2 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.mlp = L.GeluMLP(cfg, generator, device)


class Unit(nn.Module):
    """One pattern unit (JAX's ``{"sub": [...]}``)."""

    def __init__(self, cfg: ModelConfig, kinds, generator=None, device=None):
        super().__init__()
        self.sub = nn.ModuleList(Sub(cfg, k, generator, device) for k in kinds)


def plan(cfg: ModelConfig):
    """(n_groups, tail kinds): n_groups full pattern units, then the
    remainder layers one by one."""
    unit = len(cfg.pattern)
    n_groups = cfg.n_layers // unit
    return n_groups, cfg.layer_kinds()[n_groups * unit :]


class GriffinLM(nn.Module):
    """embed (vocab, d), groups[max(n_groups, 1)], tail[len(tail)], ln_f (d,),
    unembed (d, vocab)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if not cfg.pattern:
            raise ValueError(f"{cfg.name}: a hybrid config needs a layer pattern")
        self.cfg = cfg
        n_groups, tail = plan(cfg)
        dt = L.torch_dtype(cfg)
        d = cfg.d_model
        self.embed = L.param((cfg.vocab, d), dt, std=d**-0.5, generator=generator, device=device)
        self.groups = nn.ModuleList(Unit(cfg, cfg.pattern, generator, device)
                                    for _ in range(max(n_groups, 1)))
        self.tail = nn.ModuleList(Unit(cfg, (kind,), generator, device) for kind in tail)
        self.ln_f = L.param((d,), torch.float32, fill=1.0, device=device)
        self.unembed = L.param((d, cfg.vocab), dt, std=d**-0.5, generator=generator,
                               device=device)


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """The JAX init's distributions (normal weights scaled by d_in^-0.5, the
    conv's normal 0.1, zero gate biases, unit norms, JAX's Λ) drawn from
    ``generator``; the numbers differ from ``jax.random``'s."""
    return GriffinLM(cfg, generator, device)


def layers(model: GriffinLM):
    """(kind, Sub) for every layer in order: the groups' units, then the tail."""
    cfg = model.cfg
    n_groups, tail = plan(cfg)
    out = [(kind, sp) for g in range(n_groups)
           for kind, sp in zip(cfg.pattern, model.groups[g].sub)]
    return out + [(kind, unit.sub[0]) for kind, unit in zip(tail, model.tail)]


def sub_apply(cfg: ModelConfig, kind: str, sp: Sub, x, positions, *, state=None,
              attn_impl: str = "kernel"):
    """One layer of the forward, or a recurrent layer of decode (with
    ``state``) -> (x, the recurrent layer's new state or None)."""
    h_in = L.rmsnorm(x, sp.ln1, cfg.norm_eps)
    if kind == "rec":
        h, new_state = rec_apply(cfg, sp.temporal, h_in, state=state)
    else:
        h, new_state = L.attention_apply(cfg, sp.temporal, h_in, positions, causal=True,
                                         window=cfg.window, attn_impl=attn_impl)
    x = x + h
    m = L.gelu_mlp_apply(sp.mlp, L.rmsnorm(x, sp.ln2, cfg.norm_eps))
    return x + m, new_state


def forward(model: GriffinLM, tokens: torch.Tensor, *, attn_impl: str = "kernel"):
    """tokens (B, S) -> logits (B, S, vocab)."""
    cfg = model.cfg
    n_groups, tail = plan(cfg)
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)

    def unit_apply(unit, kinds, x):
        for kind, sp in zip(kinds, unit.sub):
            x, _ = sub_apply(cfg, kind, sp, x, positions, attn_impl=attn_impl)
        return x

    for g in range(n_groups):
        x = L.remat(lambda x, unit=model.groups[g]: unit_apply(unit, cfg.pattern, x), x)
    for kind, unit in zip(tail, model.tail):
        x = unit_apply(unit, (kind,), x)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    return x @ model.unembed


def loss_fn(model: GriffinLM, batch: dict, *, attn_impl: str = "kernel") -> torch.Tensor:
    """The mean f32 cross-entropy of ``batch["labels"]``."""
    return L.token_ce(forward(model, batch["tokens"], attn_impl=attn_impl), batch["labels"])


# -- decode -------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Per-layer state: a recurrent layer's h (B, d_rnn) in f32 and conv tail
    (B, CW-1, d_rnn); an attention layer's ring of ``min(window, max_len)``
    K/V slots, in the model's dtype.  ``groups`` is a list (one per unit) of
    lists (one per layer of the unit), where JAX stacks the units."""
    n_groups, tail = plan(cfg)
    dr = cfg.d_rnn or cfg.d_model
    KV, Dh, CW = cfg.n_kv_heads, cfg.d_head, cfg.conv_width
    wlen = min(cfg.window or max_len, max_len)
    dt = L.torch_dtype(cfg)

    def state(kind):
        z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=device)
        if kind == "rec":
            return {"h": z(batch, dr, dtype=torch.float32), "conv": z(batch, CW - 1, dr)}
        return {"k": z(batch, wlen, KV, Dh), "v": z(batch, wlen, KV, Dh)}

    return {
        "groups": [[state(kind) for kind in cfg.pattern] for _ in range(n_groups)],
        "tail": [state(kind) for kind in tail],
        "len": 0,
    }


@torch.no_grad()
def decode_fn(model: GriffinLM, cache: dict, tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), cache).

    Each recurrent layer's state is replaced and each ring written in place;
    the same dict is returned.  ``len`` is a host int (the JAX package carries
    it as a traced scalar)."""
    cfg = model.cfg
    n_groups, tail = plan(cfg)
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    pos = cache["len"]

    def layer_apply(kind, sp, st, x):
        if kind == "rec":
            return sub_apply(cfg, kind, sp, x, None, state=st)
        # ring-buffer window cache: slot = pos % W
        slot = pos % st["k"].shape[1]
        h_in = L.rmsnorm(x, sp.ln1, cfg.norm_eps)
        x = x + window_decode_attn(cfg, sp.temporal, h_in, st, slot, pos)
        return x + L.gelu_mlp_apply(sp.mlp, L.rmsnorm(x, sp.ln2, cfg.norm_eps)), st

    for g in range(n_groups):
        states = cache["groups"][g]
        for j, (kind, sp) in enumerate(zip(cfg.pattern, model.groups[g].sub)):
            x, states[j] = layer_apply(kind, sp, states[j], x)
    for t, (kind, unit) in enumerate(zip(tail, model.tail)):
        x, cache["tail"][t] = layer_apply(kind, unit.sub[0], cache["tail"][t], x)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    cache["len"] = pos + 1
    return x @ model.unembed, cache


def window_decode_attn(cfg: ModelConfig, ap: L.Attention, x, st: dict, slot: int, pos: int):
    """MQA/GQA decode against a ring-buffer window cache: the new K/V written
    at ``slot`` (in place), RoPE at ``pos``, and the slots whose key position
    ``pos - age`` is at least 0 and inside the window attended.  Plain torch
    (einsum, f32 softmax, the probabilities cast to q's dtype), as JAX's
    ``_window_decode_attn`` is plain jnp.  -> out (B, 1, d)."""
    B = x.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ ap.wq).reshape(B, 1, H, Dh)
    k_new = (x @ ap.wk).reshape(B, 1, KV, Dh)
    v_new = (x @ ap.wv).reshape(B, 1, KV, Dh)
    if cfg.qkv_bias:
        q = q + ap.bq.reshape(1, 1, H, Dh)
        k_new = k_new + ap.bk.reshape(1, 1, KV, Dh)
        v_new = v_new + ap.bv.reshape(1, 1, KV, Dh)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = L.rope(q, positions, cfg.rope_theta)
    k_new = L.rope(k_new, positions, cfg.rope_theta)
    k_cache, v_cache = st["k"], st["v"]
    k_cache[:, slot : slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot : slot + 1] = v_new.to(v_cache.dtype)
    Wn = k_cache.shape[1]
    ages = (slot - torch.arange(Wn, device=x.device)) % Wn  # each slot's age in steps
    kpos = pos - ages
    valid = (kpos >= 0) & (kpos > pos - (cfg.window or Wn))
    G = H // KV
    qh = q.transpose(1, 2).reshape(B, KV, G, 1, Dh) * (Dh**-0.5)
    kh = k_cache.transpose(1, 2)
    vh = v_cache.transpose(1, 2)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh.to(qh.dtype))
    s = torch.where(valid[None, None, None, None, :], s, -1e30)
    p = torch.softmax(s.float(), dim=-1).to(qh.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vh.to(qh.dtype))
    o = o.reshape(B, H, 1, Dh).transpose(1, 2).reshape(B, 1, H * Dh)
    return o @ ap.wo
