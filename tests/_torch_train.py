"""Shared helpers of the port's training tests (JAX package vs repro_torch).

Both packages get the same weights (``numpy_params``, the JAX layout) and
the same batch (``SyntheticTokens``, with the seeded frames or patch
embeddings the JAX ``train_loop`` draws); the port's gradient comes back in
the JAX layout through ``export_tree``, leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import step_inputs
from repro_torch.models.convert import export_tree, load_jax_params, numpy_params
from repro_torch.models.registry import get_model

B, S = 2, 12
DENSE = ["qwen1_5_0_5b", "phi3_medium_14b", "minitron_4b", "starcoder2_3b", "pixtral_12b"]
MOE = ["qwen3_moe_235b_a22b", "llama4_scout_17b_16e"]
RECURRENT = ["rwkv6_3b", "recurrentgemma_9b", "whisper_large_v3"]
# f32 on both sides, other summation orders: each gradient leaf within this
# share of its largest entry (the loss within LOSS_TOL)
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one CPU thread for the test: these small models train faster
    so, and the suite's workers do not oversubscribe the cores (a test
    module imports this fixture to use it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat(v, name + "."))
        else:
            out[name] = v
    return out


def batch_np(cfg, batch=B, seq=S, seed=0, it=0) -> dict:
    """The pipeline's batch ``it`` and that step's stub inputs, as numpy."""
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=seq + 1, global_batch=batch, seed=seed)
    pipe.restore({"step": it})
    b = {k: v.numpy() for k, v in pipe.next_batch(device="cpu").items()}
    b.update({k: v.numpy() for k, v in step_inputs(cfg, batch, seed, it, "cpu").items()})
    return b


def jax_value_and_grad(arch, tree, b):
    """JAX's ``value_and_grad(model.loss_fn)`` (blockwise attention, the
    reference recurrence, per-layer remat: its training path)."""
    model = jax_get_model(jax_smoke(arch))
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.value_and_grad(lambda p: model.loss_fn(p, jb))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_model(arch, tree):
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    return model, load_jax_params(model.init(device="cpu"), tree)


def port_value_and_grad(arch, tree, b, loss_fn=None):
    """The port's loss (the registry's ``loss_fn`` by default: the kernel
    routes, which take their plain versions on the CPU) and its gradient in
    the JAX layout."""
    model, params = port_model(arch, tree)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = (loss_fn or model.loss_fn)(params, tb)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    g = {k: torch.zeros_like(p) if d is None else d for (k, p), d in zip(named.items(), grads)}
    return float(loss.detach()), jax.tree.map(lambda t: t.numpy(), export_tree(params, g))


def assert_matches_jax(arch, tree, b):
    """The port's loss and every gradient leaf against JAX's."""
    lj, gj = jax_value_and_grad(arch, tree, b)
    lp, gp = port_value_and_grad(arch, tree, b)
    assert abs(lp - lj) <= LOSS_TOL * abs(lj), (lp, lj)
    gaps = leaf_gaps(gj, gp)
    assert max(gaps.values()) <= GRAD_TOL, {k: v for k, v in gaps.items() if v > GRAD_TOL}
    assert all(np.abs(v).max() > 0 for v in flat(gj).values())  # every leaf is reached


def leaf_gaps(want: dict, got: dict) -> dict:
    """{leaf: max |got - want| / max(|want|.max(), 1e-30)} over every leaf."""
    fw, fg = flat(want), flat(got)
    assert fw.keys() == fg.keys()
    return {k: float(np.abs(fg[k] - fw[k]).max() / max(np.abs(fw[k]).max(), 1e-30))
            for k in fw}


def seeded(arch, seed=0):
    cfg = get_smoke_config(arch)
    return cfg, numpy_params(cfg, seed)
