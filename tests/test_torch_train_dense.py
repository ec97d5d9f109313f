"""The port's training loss and gradient against JAX's: the dense and VLM
transformers, on the CPU.

For the qwen1.5 (QKV biases), phi3 (MQA), minitron and starcoder2 (GQA)
smoke configs and pixtral's (a patch prefix, only the tokens scored), in
f32: the same ``numpy_params`` tree and the same ``SyntheticTokens`` batch
(pixtral's with the patch embeddings JAX's ``train_loop`` draws for step 0)
go through JAX's ``jax.value_and_grad(model.loss_fn)`` (blockwise
attention, per-layer remat) and the port's ``Model.loss_fn`` with torch
autograd (the kernel route, on the CPU its plain version, remat per block).
The losses agree within 1e-5 (relative) and every gradient leaf, in the JAX
layout, within 1e-4 of its largest entry; every leaf's gradient is nonzero.
The MoE and recurrent families are held in ``test_torch_train_moe.py`` and
``test_torch_train_recurrent.py`` (split so that ``--dist loadfile``
spreads JAX's compiles).
"""

import pytest

from _torch_train import DENSE, MOE, RECURRENT, assert_matches_jax, batch_np, seeded
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    cfg, tree = seeded(arch, seed=1)
    assert_matches_jax(arch, tree, batch_np(cfg, seed=2))


def test_every_arch_is_held():
    assert sorted(DENSE + MOE + RECURRENT) == sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
