"""Bit primitives and the plain ``batched_degrees`` against the JAX package.

The port's plain version (what the CPU path runs, and what the CUDA kernel
is held against on the card) must equal the JAX package's jnp reference
and its Pallas kernel in interpret mode, exactly.  Shapes cover a partial
last word (n = 1, 31, 33, 100, 600), an exact one (32) and batches of
1, 2, 9 and 64 tasks; masks include empty, full and bit 31.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32, u32

from repro.graphs.generators import erdos_renyi
from repro.kernels.bitset_ops.kernel import batched_degrees as jax_kernel
from repro.kernels.bitset_ops.ref import batched_degrees_ref as jax_ref
from repro.problems import base as jb
from repro_torch.graphs.bitgraph import mask_full, n_words
from repro_torch.kernels import counts
from repro_torch.kernels.bitset_ops import (
    batched_degrees,
    batched_degrees_ref,
    degrees_op,
    popcount32,
)
from repro_torch.problems import base as tb

NS = (1, 31, 32, 33, 100, 600)
TS = (1, 2, 9, 64)


def _masks(n, T, seed):
    """Random masks, then the special rows: empty, full, single bit 31 (or
    the last vertex when n < 32), single bit 0."""
    rng = np.random.default_rng(seed)
    W = n_words(n)
    masks = random_masks(rng, n, W, T)
    special = [
        np.zeros(W, np.uint32),
        mask_full(n),
        np.eye(1, W, dtype=np.uint32)[0] * np.uint32(1 << min(31, n - 1)),
        np.eye(1, W, dtype=np.uint32)[0],
    ]
    for i, row in enumerate(special[:T]):
        masks[i] = row
    return masks


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("T", TS)
def test_plain_degrees_match_jax_ref(n, T):
    g = erdos_renyi(n, min(1.0, 6.0 / max(n - 1, 1)), 1000 + n)
    masks = _masks(n, T, n * 7 + T)
    want = np.asarray(jax_ref(jnp.asarray(g.adj), jnp.asarray(masks)))
    got = batched_degrees_ref(t32(g.adj), t32(masks)).numpy()
    assert got.dtype == np.int32
    assert (got == want).all()
    # the wrapper on CPU tensors is the plain version, and launches nothing
    counts.reset()
    assert (batched_degrees(t32(g.adj), t32(masks)).numpy() == want).all()
    assert (degrees_op(t32(g.adj), t32(masks)).numpy() == want).all()
    assert counts.snapshot() == {}


@pytest.mark.parametrize("n,T", [(1, 2), (33, 9), (100, 64), (600, 9)])
def test_plain_degrees_match_jax_kernel_interpret(n, T):
    g = erdos_renyi(n, min(1.0, 6.0 / max(n - 1, 1)), 2000 + n)
    masks = _masks(n, T, n + T)
    want = np.asarray(
        jax_kernel(jnp.asarray(g.adj), jnp.asarray(masks), interpret=True)
    )
    assert (batched_degrees_ref(t32(g.adj), t32(masks)).numpy() == want).all()


def test_kernel_wrapper_checks_inputs():
    adj = torch.zeros((40, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        batched_degrees(adj.long(), torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="words"):
        batched_degrees(adj, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        batched_degrees(torch.zeros((70, 2), dtype=torch.int32), torch.zeros((3, 2), dtype=torch.int32))


@pytest.mark.parametrize("seed", range(3))
def test_bit_primitives_match_jax(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(17, 5), dtype=np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    words[2] = 0
    # popcount, per word and summed
    assert (
        popcount32(t32(words)).numpy()
        == np.bitwise_count(words).astype(np.int32)
    ).all()
    assert (tb.popcount(t32(words)).numpy() == np.asarray(jb.popcount(jnp.asarray(words)))).all()
    # unpack / pack round trip at a partial and an exact width
    for n in (150, 160):
        bits_j = np.asarray(jb.unpack_bits(jnp.asarray(words), n))
        bits_t = tb.unpack_bits(t32(words), n).numpy()
        assert (bits_t == bits_j).all()
        packed_j = np.asarray(jb.pack_bits(jnp.asarray(bits_j), 5))
        assert (u32(tb.pack_bits(torch.from_numpy(bits_t), 5)) == packed_j).all()
    # single_bit, bit 31 of a word included
    vs = (0, 31, 32, 63, 159)
    want = np.stack([np.asarray(jb.single_bit(jnp.int32(v), 5)) for v in vs])
    assert (u32(tb.single_bit(torch.tensor(vs), 5)) == want).all()
