"""The port's WKV6 recurrence against the JAX package's, on the CPU.

The same numpy inputs go through JAX's ``wkv6`` (the Pallas kernel in
interpret mode), ``wkv6_op(impl="pallas")``, ``wkv6_ref`` and
``wkv6_decode_step``, and through the port's ``wkv6`` (its CPU route: the
kernel's plain version), ``wkv6_op``, ``wkv6_ref`` and ``wkv6_decode_step``.
JAX's cases and tolerance (3e-4, ``tests/test_kernels_wkv6.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.kernels.wkv6 import wkv6_decode_step as jax_step
from repro.kernels.wkv6 import wkv6_op as jax_op
from repro.kernels.wkv6 import wkv6_ref as jax_ref
from repro_torch.kernels import counts
from repro_torch.kernels.wkv6 import wkv6, wkv6_decode_step, wkv6_op, wkv6_ref

TOL = 3e-4


def make(B, T, H, K, V, seed):
    """r, k, v, decay, u, s0 as f32 numpy, drawn as JAX's test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    r, k = f(B, T, H, K), f(B, T, H, K)
    v = f(B, T, H, V)
    w = rng.uniform(0.2, 3.0, (B, T, H, K)).astype(np.float32)
    d = np.exp(-np.exp(-w)).astype(np.float32)
    u = f(H, K) * np.float32(0.6)
    s0 = f(B, H, K, V) * np.float32(0.4)
    return r, k, v, d, u, s0


def J(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def P(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def err(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


SHAPES = [
    (2, 64, 2, 16, 16, 16),
    (1, 128, 4, 32, 32, 32),
    (2, 96, 1, 8, 24, 32),
    (1, 32, 2, 64, 64, 8),
    (1, 64, 3, 16, 48, 64),
]


@pytest.mark.parametrize("B,T,H,K,V,chunk", SHAPES)
@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_matches_jax_kernel(B, T, H, K, V, chunk, with_state):
    r, k, v, d, u, s0 = make(B, T, H, K, V, T + K)
    s0 = s0 if with_state else None
    o_j, s_j = jax_wkv6(*J((r, k, v, d, u, s0)), chunk=chunk)
    o_jr, s_jr = jax_ref(*J((r, k, v, d, u, s0)))
    counts.reset()
    o, s = wkv6(*P((r, k, v, d, u, s0)))
    assert counts.snapshot() == {}  # a CPU tensor launches nothing
    assert o.dtype == torch.float32 and o.shape == (B, T, H, V) and s.shape == (B, H, K, V)
    for got, want in ((o, o_j), (s, s_j), (o, o_jr), (s, s_jr)):
        assert err(got, want) < TOL


@pytest.mark.parametrize("T", [1, 7, 50, 97])
def test_ragged_t_matches_jax_op(T):
    """JAX's op pads T to a chunk multiple with identity decays; the port
    runs any T."""
    r, k, v, d, u, s0 = make(2, T, 2, 16, 16, T)
    o_j, s_j = jax_op(*J((r, k, v, d, u, s0)), impl="pallas", chunk=16)
    for impl in ("kernel", "ref"):
        o, s = wkv6_op(*P((r, k, v, d, u, s0)), impl=impl)
        assert o.shape == (2, T, 2, 16)
        assert err(o, o_j) < TOL and err(s, s_j) < TOL, impl


def test_ref_matches_jax_ref_exactly_enough():
    r, k, v, d, u, s0 = make(1, 40, 2, 16, 16, 9)
    o_j, s_j = jax_ref(*J((r, k, v, d, u, s0)))
    o, s = wkv6_ref(*P((r, k, v, d, u, s0)))
    assert err(o, o_j) < 1e-5 and err(s, s_j) < 1e-5


def test_decode_steps_chain_to_scan():
    """T single decode steps == the full recurrence, in both packages."""
    B, T, H, K, V = 1, 12, 2, 8, 8
    r, k, v, d, u, s0 = make(B, T, H, K, V, 12)
    o_ref, s_ref = wkv6_ref(*P((r, k, v, d, u, s0)))
    tr, tk, tv, td, tu, ts = P((r, k, v, d, u, s0))
    S, SJ = ts, jnp.asarray(s0)
    for t in range(T):
        o, S = wkv6_decode_step(tr[:, t], tk[:, t], tv[:, t], td[:, t], tu, S)
        oj, SJ = jax_step(*J((r[:, t], k[:, t], v[:, t], d[:, t], u)), SJ)
        assert err(o, o_ref[:, t]) < 1e-5
        assert err(o, oj) < 1e-5
    assert err(S, s_ref) < 1e-5 and err(S, SJ) < 1e-5


def test_split_sequence_carries_state():
    """Two calls with the state carried between them == one call."""
    r, k, v, d, u, s0 = P(make(2, 48, 2, 16, 16, 4))
    o, s = wkv6(r, k, v, d, u, s0)
    o1, s1 = wkv6(r[:, :20], k[:, :20], v[:, :20], d[:, :20], u, s0)
    o2, s2 = wkv6(r[:, 20:], k[:, 20:], v[:, 20:], d[:, 20:], u, s1)
    assert err(torch.cat([o1, o2], 1), o) < 1e-5 and err(s2, s) < 1e-5


def test_decay_is_clipped_as_the_tpu_kernel_clips():
    r, k, v, d, u, s0 = make(1, 16, 1, 8, 8, 5)
    d[:, 3] = 0.0  # underflowed decay: the TPU kernel takes log(clip(d, 1e-30))
    o_j, s_j = jax_wkv6(*J((r, k, v, d, u, s0)), chunk=16)
    o, s = wkv6(*P((r, k, v, d, u, s0)))
    assert err(o, o_j) < TOL and err(s, s_j) < TOL


def test_wrapper_rejects_bad_inputs():
    r, k, v, d, u, s0 = P(make(1, 8, 2, 8, 8, 6))
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, d, u[:1], s0)
    with pytest.raises(ValueError, match="initial_state"):
        wkv6(r, k, v, d, u, s0[:, :1])
    # a meta tensor (the dry run's) takes the meta route: shapes, no launch
    o, s = wkv6(*(t.to("meta") for t in (r, k, v, d, u, s0)))
    assert o.device.type == s.device.type == "meta"
    assert o.shape == v.shape and s.shape == s0.shape
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        wkv6_op(r, k, v, d, u, s0, impl="pallas")
