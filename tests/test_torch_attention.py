"""The port's attention tiers against the JAX package's, on the CPU.

The same numpy inputs go through JAX's ``attention_ref``,
``blockwise_attention`` and ``flash_attention`` (the Pallas kernel in
interpret mode) and through the port's ``attention_ref``,
``blockwise_attention`` and ``attention_op`` (its CPU route: the kernel's
plain version).  JAX's CASES and tolerances (1e-5 in f32, 2e-2 in bf16,
``tests/test_kernels_attention.py``), and three cases at head size 256
(window, MQA, one query, non-causal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import blockwise_attention as jax_blockwise
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import counts
from repro_torch.kernels.flash_attention import (
    attention_op,
    attention_ref,
    blockwise_attention,
    flash_attention,
)

CASES = [
    dict(B=2, Sq=64, Sk=64, Hq=4, Hkv=2, D=32, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, Hq=4, Hkv=1, D=64, causal=True, window=32),
    dict(B=2, Sq=1, Sk=96, Hq=8, Hkv=4, D=32, causal=True, window=None),
    dict(B=1, Sq=50, Sk=50, Hq=2, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=1, D=32, causal=True, window=None),
    dict(B=1, Sq=1, Sk=77, Hq=4, Hkv=2, D=64, causal=True, window=24),
    dict(B=3, Sq=33, Sk=33, Hq=6, Hkv=3, D=8, causal=True, window=16),
    # recurrentgemma's local attention: D 256, one KV head (MQA), a window
    dict(B=1, Sq=80, Sk=80, Hq=4, Hkv=1, D=256, causal=True, window=24),
    dict(B=2, Sq=1, Sk=45, Hq=2, Hkv=1, D=256, causal=True, window=16),
    # whisper's encoder: non-causal, a key tail off the block size
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=2, D=256, causal=False, window=None),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(case, seed):
    """f32 numpy q, k, v for a case (rounded to bf16 by each package)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = case
    return (f(c["B"], c["Sq"], c["Hq"], c["D"]), f(c["B"], c["Sk"], c["Hkv"], c["D"]),
            f(c["B"], c["Sk"], c["Hkv"], c["D"]))


def to_jax(arrs, dtype):
    return [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]


def to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def mask_kw(case):
    return dict(causal=case["causal"], window=case["window"])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_op_matches_jax_flash_kernel(case, dtype):
    arrs = make(case, 0)
    jq, jk, jv = to_jax(arrs, dtype)
    # JAX's own check: the kernel against the f32 oracle on the rounded inputs
    want_ref = f32(jax_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                           jv.astype(jnp.float32), **mask_kw(case)))
    want = f32(jax_flash(jq, jk, jv, block_q=32, block_k=32, **mask_kw(case)))
    counts.reset()
    got = attention_op(*to_torch(arrs, dtype), **mask_kw(case))
    assert counts.snapshot() == {}  # a CPU tensor launches nothing
    assert got.dtype == TORCH[dtype] and got.shape == want.shape
    assert np.abs(f32(got) - want).max() < TOL[dtype]
    assert np.abs(f32(got) - want_ref).max() < TOL[dtype]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(case, dtype):
    arrs = make(case, 1)
    want = f32(jax_ref(*to_jax(arrs, dtype), **mask_kw(case)))
    got = attention_ref(*to_torch(arrs, dtype), **mask_kw(case))
    assert got.dtype == TORCH[dtype]
    assert np.abs(f32(got) - want).max() < TOL[dtype]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_jax_blockwise(case, dtype):
    arrs = make(case, 2)
    want = f32(jax_blockwise(*to_jax(arrs, dtype), block_k=16, **mask_kw(case)))
    got = blockwise_attention(*to_torch(arrs, dtype), block_k=16, **mask_kw(case))
    assert got.dtype == TORCH[dtype]
    assert np.abs(f32(got) - want).max() < TOL[dtype]
    # and the f32 oracle, as JAX's test_blockwise_path holds its own
    if dtype == "float32":
        ref = attention_ref(*to_torch(arrs, dtype), **mask_kw(case))
        assert np.abs(f32(got) - f32(ref)).max() < 1e-5


def test_block_size_invariance():
    case = dict(B=1, Sq=96, Sk=96, Hq=2, Hkv=2, D=32)
    q, k, v = to_torch(make(case, 3), "float32")
    ref = attention_ref(q, k, v, causal=True)
    for bk in (16, 32, 64, 96, 128):
        got = blockwise_attention(q, k, v, causal=True, block_k=bk)
        assert (got - ref).abs().max() < 1e-5, bk
    assert (flash_attention(q, k, v, causal=True) - ref).abs().max() < 1e-5


def test_impls_and_strided_inputs():
    case = dict(B=2, Sq=40, Sk=40, Hq=4, Hkv=2, D=16)
    q, k, v = to_torch(make(case, 4), "float32")
    outs = [attention_op(q, k, v, impl=i) for i in ("kernel", "blockwise", "ref")]
    for o in outs[1:]:
        assert (o - outs[0]).abs().max() < 1e-5
    # a (B, H, S, D) tensor viewed as (B, S, H, D): the wrapper takes strides
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    assert (flash_attention(qt, k, v) - outs[0]).abs().max() == 0
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention_op(q, k, v, impl="pallas")


def test_wrapper_rejects_bad_inputs():
    case = dict(B=1, Sq=8, Sk=8, Hq=3, Hkv=2, D=8)
    q, k, v = to_torch(make(case, 5), "float32")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q[:, :, :2], k.double(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[:, :, :2], k, v, window=0)
    # a meta tensor (the dry run's) takes the meta route: shapes, no launch
    out = flash_attention(*(t[:, :, :2].to("meta") for t in (q, k, v)))
    assert out.device.type == "meta" and out.shape == q[:, :, :2].shape
