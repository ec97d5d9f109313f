"""The port's training loss and gradient against JAX's: RWKV6, Griffin and
Whisper, on the CPU.

As ``test_torch_train_dense.py``, for the rwkv6 smoke config (the ``wkv6``
kernel route, on the CPU its plain version, against JAX's reference
recurrence), recurrentgemma's (5 layers: one rematerialised unit of rec,
rec, attn and a tail of two recurrent layers; Λ trained) and whisper's (the
encoder over the frames JAX's ``train_loop`` draws for step 0, the decoder
over the tokens; both stacks rematerialised).  Losses within 1e-5, every
gradient leaf within 1e-4 of its largest entry, every leaf reached.  Also
Griffin's out-of-place scan (the training form) against the in-place one.
"""

import numpy as np
import pytest
import torch

from _torch_train import RECURRENT, assert_matches_jax, batch_np, seeded
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.models.griffin import linear_scan


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_and_grads_match_jax(arch):
    cfg, tree = seeded(arch, seed=3)
    assert_matches_jax(arch, tree, batch_np(cfg, seed=4))


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_linear_scan_forms_agree(T):
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, T, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, T, 3)).astype(np.float32))
    with torch.no_grad():
        in_place = linear_scan(a, b)
    out_of_place = linear_scan(a.requires_grad_(True), b.requires_grad_(True))
    assert out_of_place.requires_grad
    assert torch.equal(in_place, out_of_place.detach())
