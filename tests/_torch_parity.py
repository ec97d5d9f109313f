"""Shared helpers of the port's parity tests (JAX package vs repro_torch).

Inputs are made with numpy from a seed and handed to both packages; packed
words travel as uint32 numpy arrays and enter the port as int32 tensors
holding the same bits.
"""

import numpy as np
import torch


def t32(words: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 CPU tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32).copy()
    )


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor words -> uint32 numpy array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def random_masks(rng: np.random.Generator, n: int, W: int, T: int) -> np.ndarray:
    """(T, W) uint32 random vertex masks over n vertices (no bits >= n)."""
    masks = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32)
    rem = n % 32
    if rem:
        masks[:, -1] &= np.uint32((1 << rem) - 1)
    return masks


def assert_flat_equal(jax_flat: dict, torch_flat: dict) -> None:
    """Two flat worker states hold the same names, dtypes and values."""
    assert sorted(jax_flat) == sorted(torch_flat)
    for name, want in jax_flat.items():
        got = torch_flat[name]
        want = np.asarray(want)
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert (got == want).all(), name
