"""The port's training loss and gradient against JAX's: the MoE
transformers, on the CPU.

As ``test_torch_train_dense.py``, for the qwen3-moe (8 experts, top-2) and
llama4-scout (4 experts, top-1) smoke configs: the router, the dispatch,
the three expert products and the ordered combine are differentiated end to
end, the aux loss (coefficient 0.01) included, with the training capacity
from the call's B·S tokens.  Each of four sequences is its own batch of one.
A routing choice is exact only where no float difference can flip it
(``test_torch_moe.py``): a sequence whose smallest gap between a token's
K-th and (K+1)-th router probability, in any layer of the port's forward,
is under 1e-4 could route otherwise in JAX, so it is set aside and counted.
Losses within 1e-5, every gradient leaf within 1e-4 of its largest entry.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from _torch_train import MOE, assert_matches_jax, batch_np, port_value_and_grad, seeded
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.models import moe

MARGIN = 1e-4
SEQUENCES = 4


def routing_margin(arch, tree, b) -> float:
    """The smallest top-K gap of the port's router over every MoE layer."""
    gaps, route = [], moe.route

    def spy(cfg, p, x):
        r = route(cfg, p, x)
        top = torch.topk(r["probs"].detach(), cfg.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return r

    with mock.patch.object(moe, "route", spy):
        port_value_and_grad(arch, tree, b)
    return min(gaps)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_jax(arch):
    cfg, tree = seeded(arch, seed=5)
    b = batch_np(cfg, batch=SEQUENCES, seed=6)
    set_aside = 0
    for i in range(SEQUENCES):
        one = {k: np.ascontiguousarray(v[i : i + 1]) for k, v in b.items()}
        if routing_margin(arch, tree, one) < MARGIN:
            set_aside += 1
            continue
        assert_matches_jax(arch, tree, one)
    print(f"{arch}: {SEQUENCES - set_aside} sequences compared, {set_aside} set aside")
    assert set_aside < SEQUENCES // 2
