"""The remat policies of ``models/layers.py`` against each other and JAX's.

``REMAT_POLICY`` ``"dots"`` (the counterpart of JAX's
``checkpoint_dots_with_no_batch_dims``: the unbatched products' outputs
saved, the rest recomputed) against ``"nothing"`` (every block rerun in the
backward pass): in f32 on the CPU the loss and every gradient leaf are
bitwise equal, and the backward reruns exactly the blocks' unbatched
products fewer FLOPs.  Against JAX with ``REMAT_POLICY = ["dots"]`` on both
sides: the loss within 1e-5 and every gradient leaf within 1e-4 of its
largest entry (``_torch_train``'s tolerances, PERF.md section 2).
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_train import assert_matches_jax, batch_np, flat, port_value_and_grad, seeded
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.models import layers as jax_layers
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model

ARCHS = ["qwen1_5_0_5b", "qwen3_moe_235b_a22b", "rwkv6_3b", "recurrentgemma_9b"]


@pytest.fixture
def policy():
    """Sets the remat policy of both packages; restores the defaults."""
    def set_policy(name):
        L.REMAT_POLICY[0] = name
        jax_layers.REMAT_POLICY[0] = name

    yield set_policy
    set_policy("nothing")


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_nothing_exactly(arch, policy):
    cfg, tree = seeded(arch, seed=1)
    b = batch_np(cfg, seed=2)
    policy("nothing")
    loss_n, grads_n = port_value_and_grad(arch, tree, b)
    policy("dots")
    loss_d, grads_d = port_value_and_grad(arch, tree, b)
    assert loss_d == loss_n
    flat_n, flat_d = flat(grads_n), flat(grads_d)
    assert flat_n.keys() == flat_d.keys()
    for k in flat_n:
        assert (flat_n[k] == flat_d[k]).all(), k


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen3_moe_235b_a22b"])
def test_dots_reruns_no_unbatched_product(arch, policy, monkeypatch):
    """A step's ``mm`` FLOPs under "dots" equal those of a step with no
    remat at all (every unbatched product saved, none rerun), and are
    fewer than under "nothing" (which reruns them); batched products
    (``bmm``) are rerun under both policies."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}

    def mm_flops():
        with FlopCounterMode(display=False) as fc:
            loss = model.loss_fn(params, batch)
            torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
        by_op = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
        return sum(n for op, n in by_op.items() if op in ("aten.mm", "aten.addmm"))

    policy("nothing")
    nothing = mm_flops()
    policy("dots")
    dots = mm_flops()
    with monkeypatch.context() as m:
        m.setattr(L, "remat", lambda fn, *args: fn(*args))
        plain = mm_flops()
    assert dots == plain < nothing


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen3_moe_235b_a22b", "rwkv6_3b"])
def test_dots_loss_and_grads_match_jax_dots(arch, policy):
    policy("dots")
    cfg, tree = seeded(arch, seed=1)
    assert_matches_jax(arch, tree, batch_np(cfg, seed=2))


def test_unknown_policy_raises(policy):
    policy("everything")
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="remat policy"):
        L.remat(lambda t: t * 2, x)
