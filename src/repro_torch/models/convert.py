"""Weights across the two packages, in the JAX package's layout.

The port keeps the JAX parameter layout leaf for leaf: a dense weight is
``(d_in, d_out)`` and applied as ``x @ W`` (not transposed into
``nn.Linear``), and a module attribute is named as the JAX dict key (a list
entry by its index), so the state-dict name of a leaf is its JAX path with
the layer index after a stacked subtree's name: ``blocks``, Griffin's
``groups`` (whose ``sub`` is a list of a unit's layers) and Whisper's
``enc_blocks`` and ``dec_blocks``.  Griffin's ``tail`` is a list of
unstacked units.

* ``load_jax_params(model, tree)`` takes the JAX package's parameter tree
  (numpy arrays or tensors; the stacked subtrees' leaves ``(L, ...)``),
  splits the stacked leaves per layer and loads them, cast to each
  parameter's dtype (an MoE router and Griffin's ``b_a``, ``b_x`` and
  ``lam`` stay f32 in a bf16 model, as in JAX).
* ``expert_shard(tree, rank, ranks)`` cuts a transformer tree's MoE banks
  to one expert-parallel model rank's experts (the router whole), for
  ``load_jax_params`` into ``init_lm(cfg, experts=...)``.
* ``export_params(model)`` is the reverse: the model's parameters as a JAX
  tree of detached tensors in their own dtypes, the stacked leaves stacked.
  ``export_tree(model, named)`` and ``import_tree(tree)`` carry any tree
  keyed like the parameters (AdamW's ``m`` and ``v``) between the port's
  flat dict of parameter names and the JAX layout, so a training state
  ``(params, OptState)`` is checkpointed in JAX's layout.
* ``numpy_params(cfg, seed)`` builds a tree of that layout from a numpy
  generator.  The tests feed the same tree to both packages, and the card
  rebuilds it without JAX.  ``patch_embeds(cfg, batch, seed)`` draws a VLM
  prompt's stub patch embeddings the same way, ``frames(cfg, batch, seed)``
  Whisper's stub frame embeddings.  Leaves are float32 (numpy has no
  bfloat16; a bfloat16 model casts them on load).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.griffin import lru_lambda
from repro_torch.models.moe import expert_range

HEAD_SIZE = 64  # rwkv6.HEAD_SIZE
# the subtrees whose leaves are stacked over layers (or Griffin's units)
STACKED = ("blocks", "groups", "enc_blocks", "dec_blocks")


def _flatten(tree, prefix: str = ""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def import_tree(tree: dict) -> dict:
    """A tree in the JAX layout -> a flat dict keyed by the port's parameter
    names, the stacked leaves split per layer (views of the stacked ones)."""
    flat = {}
    for name, leaf in _flatten(tree):
        head, _, rest = name.partition(".")
        leaf = _tensor(leaf)
        if head in STACKED:
            for i in range(leaf.shape[0]):
                flat[f"{head}.{i}.{rest}"] = leaf[i]
        else:
            flat[name] = leaf
    return flat


def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX parameter tree into ``model`` (every leaf, strictly)."""
    model.load_state_dict(import_tree(tree), strict=True)
    return model


def expert_shard(tree: dict, rank: int, ranks: int) -> dict:
    """A transformer's JAX tree with each MoE bank cut to model rank
    ``rank``'s experts of ``ranks`` (``w1``/``w3``/``w2`` (L, E, ...) ->
    (L, E/ranks, ...); the router whole): what an expert-parallel rank
    loads (``load_jax_params`` into ``init_lm(cfg, experts=expert_range(...))``)."""
    moe = tree["blocks"]["moe"]
    lo, hi = expert_range(moe["w1"].shape[1], rank, ranks)
    cut = {**moe, **{k: moe[k][:, lo:hi] for k in ("w1", "w3", "w2")}}
    return {**tree, "blocks": {**tree["blocks"], "moe": cut}}


def export_tree(model: nn.Module, named: dict) -> dict:
    """``named`` (a flat dict keyed by ``model``'s parameter names, as
    ``dict(model.named_parameters())`` or AdamW's moments over it) as a tree
    in the JAX layout of ``param_shapes(model.cfg)``, the stacked leaves
    stacked over layers."""

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path + (str(i),)) for i, v in enumerate(node)]
        head, rest = path[0], ".".join(path[1:])
        if head in STACKED:
            return torch.stack([named[f"{head}.{i}.{rest}"] for i in range(node[0][0])])
        return named[".".join(path)]

    with torch.no_grad():
        return build(param_shapes(model.cfg), ())


def export_params(model: nn.Module) -> dict:
    """The model's parameters as a JAX parameter tree of detached tensors
    (each in its parameter's dtype)."""
    return export_tree(model, {k: v.detach() for k, v in model.named_parameters()})


def _stack(node, n: int):
    """A subtree of (shape, kind) leaves, each stacked over n."""
    if isinstance(node, dict):
        return {k: _stack(v, n) for k, v in node.items()}
    if isinstance(node, list):
        return [_stack(v, n) for v in node]
    shape, kind = node
    return ((n, *shape), kind)


def param_shapes(cfg: ModelConfig) -> dict:
    """The JAX tree's leaves for ``cfg``: path -> (shape, kind), with the
    stacked subtrees' leaves stacked over layers (Griffin's ``groups`` over
    max(n_groups, 1) units, as JAX's init).  Kinds: weight (normal, scaled by
    d_in^-0.5), norm, bias, mix, decay0, bonus, lam (Griffin's Λ, fixed)."""
    d, V, Lr = cfg.d_model, cfg.vocab, cfg.n_layers
    H, KV, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    tree = {"embed": ((V, d), "embed")}
    attn = {"wq": ((d, H * Dh), "weight"), "wk": ((d, KV * Dh), "weight"),
            "wv": ((d, KV * Dh), "weight"), "wo": ((H * Dh, d), "weight")}
    if cfg.qkv_bias:
        attn.update(bq=((H * Dh,), "bias"), bk=((KV * Dh,), "bias"),
                    bv=((KV * Dh,), "bias"))
    gelu_mlp = {"wi": ((d, f), "weight"), "wo": ((f, d), "weight")}
    if cfg.family == "hybrid":
        dr, CW = cfg.d_rnn or d, cfg.conv_width
        rec = {"w_gate": ((d, dr), "weight"), "w_in": ((d, dr), "weight"),
               "conv": ((CW, dr), "weight"), "w_a": ((dr, dr), "weight"),
               "b_a": ((dr,), "bias"), "w_x": ((dr, dr), "weight"),
               "b_x": ((dr,), "bias"), "lam": ((dr,), "lam"), "w_out": ((dr, d), "weight")}

        def unit(kinds):
            return {"sub": [{"ln1": ((d,), "norm"),
                             "temporal": rec if kind == "rec" else attn,
                             "ln2": ((d,), "norm"), "mlp": gelu_mlp} for kind in kinds]}

        unit_len = len(cfg.pattern)
        n_groups = Lr // unit_len
        tree["groups"] = _stack(unit(cfg.pattern), max(n_groups, 1))
        tree["tail"] = [unit((kind,)) for kind in cfg.layer_kinds()[n_groups * unit_len :]]
        tree["ln_f"] = ((d,), "norm")
        tree["unembed"] = ((d, V), "embed")
        return tree
    if cfg.family == "encdec":
        enc = {"ln1": ((d,), "norm"), "attn": attn, "ln2": ((d,), "norm"), "mlp": gelu_mlp}
        dec = {"ln1": ((d,), "norm"), "attn": attn, "lnx": ((d,), "norm"), "xattn": attn,
               "ln2": ((d,), "norm"), "mlp": gelu_mlp}
        tree["enc_blocks"] = _stack(enc, cfg.n_enc_layers)
        tree["enc_ln"] = ((d,), "norm")
        tree["dec_blocks"] = _stack(dec, Lr)
        tree["ln_f"] = ((d,), "norm")
        tree["unembed"] = ((d, V), "embed")
        return tree
    if cfg.family in ("dense", "moe", "vlm"):
        block = {"ln1": ((d,), "norm"), "attn": attn, "ln2": ((d,), "norm")}
        if cfg.is_moe:
            E = cfg.n_experts
            block["moe"] = {"router": ((d, E), "weight"), "w1": ((E, d, f), "weight"),
                            "w3": ((E, d, f), "weight"), "w2": ((E, f, d), "weight")}
        else:
            block["mlp"] = {"w1": ((d, f), "weight"), "w3": ((d, f), "weight"),
                            "w2": ((f, d), "weight")}
    elif cfg.family == "ssm":
        r, H = cfg.decay_lora, d // HEAD_SIZE
        block = {
            "ln1": ((d,), "norm"),
            "tmix": {"mu": ((5, d), "mix"), "wr": ((d, d), "weight"),
                     "wk": ((d, d), "weight"), "wv": ((d, d), "weight"),
                     "wg": ((d, d), "weight"), "wo": ((d, d), "weight"),
                     "w0": ((d,), "decay0"), "wa": ((d, r), "weight"),
                     "wb": ((r, d), "weight"), "u": ((H, HEAD_SIZE), "bonus"),
                     "ln_g": ((d,), "norm")},
            "ln2": ((d,), "norm"),
            "cmix": {"mu": ((2, d), "mix"), "wk": ((d, f), "weight"),
                     "wv": ((f, d), "weight"), "wr": ((d, d), "weight")},
        }
    else:
        raise ValueError(f"param_shapes: unknown family {cfg.family!r}")
    tree["blocks"] = _stack(block, Lr)
    tree["ln_f"] = ((d,), "norm")
    tree["unembed"] = ((d, V), "embed")
    return tree


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """Seeded float32 weights in the JAX layout, drawn leaf by leaf in the
    tree's order.  Norm gains, biases, token-shift mixes, decay offsets and
    bonuses are drawn too (not left at the init's constants), so every
    parameter matters to the output."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        shape, kind = node
        if kind == "embed":
            a = rng.standard_normal(shape) * cfg.d_model**-0.5
        elif kind == "weight":
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        elif kind == "norm":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "bias":
            a = 0.1 * rng.standard_normal(shape)
        elif kind == "mix":
            a = rng.uniform(0.0, 1.0, shape)
        elif kind == "decay0":
            a = rng.uniform(-3.0, 0.0, shape)
        elif kind == "lam":  # JAX's init's formula, broadcast over any stacking
            a = np.broadcast_to(lru_lambda(shape[-1]).numpy(), shape)
        else:  # bonus
            a = 0.5 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return draw(param_shapes(cfg))


def frames(cfg: ModelConfig, batch: int, seed: int) -> np.ndarray:
    """Whisper's stub frame embeddings (batch, enc_seq, d) in float32,
    standard normal: the conv/mel frontend is a stub in the JAX package too,
    whose batches carry precomputed frames."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def patch_embeds(cfg: ModelConfig, batch: int, seed: int) -> np.ndarray:
    """A VLM prompt's stub patch embeddings (batch, n_patches, d) in float32,
    normal with the token embeddings' scale d^-0.5.  The vision frontend is
    a stub in the JAX package too: its batches carry precomputed
    embeddings."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.n_patches, cfg.d_model)
    return (rng.standard_normal(shape) * cfg.d_model**-0.5).astype(np.float32)
