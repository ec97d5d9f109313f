"""Weights across the two packages, in the JAX package's layout.

The port keeps the JAX parameter layout leaf for leaf: a dense weight is
``(d_in, d_out)`` and applied as ``x @ W`` (not transposed into
``nn.Linear``), and a module attribute is named as the JAX dict key, so the
state-dict name of a leaf is its JAX path with the layer index after
``blocks``.

* ``load_jax_params(model, tree)`` takes the JAX package's parameter tree
  (numpy arrays; ``blocks`` leaves stacked ``(L, ...)``), splits the stacked
  leaves per layer and loads them, cast to each parameter's dtype.
* ``numpy_params(cfg, seed)`` builds a tree of that layout from a numpy
  generator.  The tests feed the same tree to both packages, and the card
  rebuilds it without JAX.  Leaves are float32 (numpy has no bfloat16; a
  bfloat16 model casts them on load).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig

HEAD_SIZE = 64  # rwkv6.HEAD_SIZE


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX parameter tree into ``model`` (every leaf, strictly)."""
    state = {}
    for name, leaf in _flatten(tree):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(leaf.shape[0]):
                state[f"blocks.{i}.{rest}"] = _tensor(leaf[i])
        else:
            state[name] = _tensor(leaf)
    model.load_state_dict(state, strict=True)
    return model


def param_shapes(cfg: ModelConfig) -> dict:
    """The JAX tree's leaves for ``cfg``: path -> (shape, kind), with
    ``blocks`` leaves stacked over layers.  Kinds: weight (normal, scaled by
    d_in^-0.5), norm, bias, mix, decay0, bonus."""
    d, V, Lr = cfg.d_model, cfg.vocab, cfg.n_layers
    tree = {"embed": ((V, d), "embed")}
    if cfg.family == "dense":
        H, KV, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
        attn = {"wq": ((d, H * Dh), "weight"), "wk": ((d, KV * Dh), "weight"),
                "wv": ((d, KV * Dh), "weight"), "wo": ((H * Dh, d), "weight")}
        if cfg.qkv_bias:
            attn.update(bq=((H * Dh,), "bias"), bk=((KV * Dh,), "bias"),
                        bv=((KV * Dh,), "bias"))
        block = {"ln1": ((d,), "norm"), "attn": attn, "ln2": ((d,), "norm"),
                 "mlp": {"w1": ((d, f), "weight"), "w3": ((d, f), "weight"),
                         "w2": ((f, d), "weight")}}
    elif cfg.family == "ssm":
        f, r, H = cfg.d_ff, cfg.decay_lora, d // HEAD_SIZE
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
        raise NotImplementedError(f"numpy_params: the {cfg.family} family is not ported")

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        shape, kind = node
        return ((Lr, *shape), kind)

    tree["blocks"] = stack(block)
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
        else:  # bonus
            a = 0.5 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return draw(param_shapes(cfg))
