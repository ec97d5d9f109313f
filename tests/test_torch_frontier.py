"""Frontier pools: the port's batched ops against the JAX ops vmapped over
workers, on random pools with many equal depths (ties) and empty workers.

Hazards named here:
* ``pop_deepest_cheap`` picks the lowest slot among the deepest, and slot 0
  with ``valid`` False for an empty worker;
* ``lax.top_k`` in ``pop_k_shallowest`` puts the lower slot first among
  equal depths; the port uses a stable argsort;
* ``push_many`` into a saturated pool drops exactly what does not fit
  (JAX's ``mode="drop"`` scatter; the port masks explicitly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32, u32

from repro.core import frontier as jf
from repro_torch.core import frontier as tf

P, CAP, W = 5, 16, 2


def _pools(seed, fill=None):
    """JAX and port frontiers holding the same random pools: depths from a
    small range (many ties), per-worker fill rates, worker 0 empty."""
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 64, W, P * CAP).reshape(P, CAP, W)
    sols = random_masks(rng, 64, W, P * CAP).reshape(P, CAP, W)
    depths = rng.integers(0, 4, size=(P, CAP)).astype(np.int32)
    rate = rng.random((P, 1)) if fill is None else np.full((P, 1), fill)
    active = rng.random((P, CAP)) < rate
    active[0] = False
    overflow = np.zeros(P, bool)
    dropped = rng.integers(0, 3, size=P).astype(np.int32)
    jax_f = jf.Frontier(
        masks=jnp.asarray(masks), sols=jnp.asarray(sols),
        depths=jnp.asarray(depths), active=jnp.asarray(active),
        overflow=jnp.asarray(overflow), dropped=jnp.asarray(dropped),
    )
    torch_f = tf.Frontier(
        masks=t32(masks), sols=t32(sols), depths=torch.from_numpy(depths),
        active=torch.from_numpy(active), overflow=torch.from_numpy(overflow),
        dropped=torch.from_numpy(dropped),
    )
    return jax_f, torch_f


def _same(jax_x, torch_x, what):
    want = np.asarray(jax_x)
    got = u32(torch_x) if want.dtype == np.uint32 else torch_x.numpy()
    assert got.shape == want.shape, what
    assert (got == want).all(), what


def _same_frontier(jax_f, torch_f):
    for name in jf.Frontier._fields:
        _same(getattr(jax_f, name), getattr(torch_f, name), name)


def _same_pop(jax_out, torch_out):
    _same_frontier(jax_out[0], torch_out[0])
    for what, a, b in zip(("masks", "sols", "depths", "valid"), jax_out[1:], torch_out[1:]):
        _same(a, b, what)


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_pop_deepest_cheap(count, seed):
    jax_f, torch_f = _pools(seed)
    want = jax.vmap(lambda f: jf.pop_deepest_cheap(f, count))(jax_f)
    _same_pop(want, tf.pop_deepest_cheap(torch_f, count))


@pytest.mark.parametrize("count", [1, 3, 5])
@pytest.mark.parametrize("seed", range(4))
def test_pop_k_shallowest_with_limit(count, seed):
    jax_f, torch_f = _pools(100 + seed)
    limit = np.random.default_rng(seed).integers(0, count + 2, size=P).astype(np.int32)
    want = jax.vmap(lambda f, lim: jf.pop_k_shallowest(f, count, limit=lim))(
        jax_f, jnp.asarray(limit)
    )
    _same_pop(want, tf.pop_k_shallowest(torch_f, count, limit=torch.from_numpy(limit)))
    # without a limit: every candidate that was active is popped
    want = jax.vmap(lambda f: jf.pop_k_shallowest(f, count))(jax_f)
    _same_pop(want, tf.pop_k_shallowest(torch_f, count))


@pytest.mark.parametrize("K", [2, 7, 20])
@pytest.mark.parametrize("seed", range(4))
def test_push_many_into_saturated_pools(K, seed):
    jax_f, torch_f = _pools(200 + seed, fill=0.85)  # few free slots
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 64, W, P * K).reshape(P, K, W)
    sols = random_masks(rng, 64, W, P * K).reshape(P, K, W)
    depths = rng.integers(0, 9, size=(P, K)).astype(np.int32)
    valid = rng.random((P, K)) < 0.7
    want = jax.vmap(jf.push_many)(
        jax_f, jnp.asarray(masks), jnp.asarray(sols), jnp.asarray(depths),
        jnp.asarray(valid),
    )
    got = tf.push_many(
        torch_f, t32(masks), t32(sols), torch.from_numpy(depths),
        torch.from_numpy(valid),
    )
    _same_frontier(want, got)
    if K == 20:  # more valid tasks than free slots somewhere
        assert bool(got.overflow.any())
        assert (got.dropped.numpy() > np.asarray(jax_f.dropped)).any()
