"""The tensor-core ``flash_attention`` variant's dispatch rule and rounding
points, on the CPU.

``select_variant`` is a pure function, checked over dtype, head size,
strides and base pointers.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here ``tc_emulation`` repeats its arithmetic
in plain torch -- q.k of the bf16 inputs in f32, the scale on the f32
scores, exp2, the online softmax over 64-key tiles, P as bf16 terms each
multiplied by v, one rounding to bf16 -- and is held against the JAX
package's ``flash_attention`` (the Pallas kernel in interpret mode) with the
card smoke's serving check: every element within one bf16 step.  An input
built so that outputs cancel shows why P is carried as several bf16 terms:
P rounded to bf16 alone fails the check there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import select_variant, variant_for

# JAX's attention cases (tests/test_kernels_attention.py:22-30)
CASES = [
    dict(B=2, Sq=64, Sk=64, Hq=4, Hkv=2, D=32, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, Hq=4, Hkv=1, D=64, causal=True, window=32),
    dict(B=2, Sq=1, Sk=96, Hq=8, Hkv=4, D=32, causal=True, window=None),
    dict(B=1, Sq=50, Sk=50, Hq=2, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=1, D=32, causal=True, window=None),
    dict(B=1, Sq=1, Sk=77, Hq=4, Hkv=2, D=64, causal=True, window=24),
    dict(B=3, Sq=33, Sk=33, Hq=6, Hkv=3, D=8, causal=True, window=16),
]
P_TERMS = 3  # bf16 terms of P in csrc/flash_attention_wgmma.cu (kPSplit)
TILE = 64  # keys per tile (kBk)


def one_step_bad(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements more than one bf16 step apart (chip_smoke.py's serving
    check: both sides round once to bf16 from f32)."""
    got, want = got.float(), want.float()
    step = 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6
    return int(((got - want).abs() > step).sum())


def tc_emulation(q, k, v, *, causal, window, p_terms):
    """The tensor-core kernel's rounding points on bf16 q, k, v (B, S, H, D)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale_log2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qh = q.float().transpose(1, 2)  # (B, Hq, Sq, D)
    kh = k.float().transpose(1, 2).repeat_interleave(G, 1)
    vh = v.float().transpose(1, 2).repeat_interleave(G, 1)
    qpos = torch.arange(Sq) + (Sk - Sq)
    acc = torch.zeros(B, Hq, Sq, D)
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros(B, Hq, Sq, 1)
    for k0 in range(0, Sk, TILE):
        kpos = torch.arange(k0, min(k0 + TILE, Sk))
        s = (qh @ kh[:, :, k0 : k0 + TILE].transpose(-1, -2)) * scale_log2
        mask = torch.ones(Sq, len(kpos), dtype=torch.bool)
        if causal:
            mask &= kpos[None] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None] > qpos[:, None] - window
        s = torch.where(mask, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(p_terms):  # each bf16 term its own P V product
            term = rest.to(torch.bfloat16).float()
            acc = acc + term @ vh[:, :, k0 : k0 + TILE]
            rest = rest - term
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


def bf16_inputs(case, seed):
    rng = np.random.default_rng(seed)
    c = case
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((c["B"], c["Sq"], c["Hq"], c["D"]), (c["B"], c["Sk"], c["Hkv"], c["D"]),
                      (c["B"], c["Sk"], c["Hkv"], c["D"]))]


def jax_out(q, k, v, **kw) -> torch.Tensor:
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)]
    out = jax_flash(*j, block_q=32, block_k=32, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize(
    "dtype,D,strides,ptrs,want",
    [
        (torch.bfloat16, 64, [65536, 1024, 64], [0, 4096, 8192], "tensor_core"),
        (torch.bfloat16, 128, [8, 16, 24], [16, 32, 48], "tensor_core"),
        (torch.bfloat16, 16, [16, 16, 16], [0, 0, 0], "tensor_core"),
        (torch.bfloat16, 80, [80, 160, 8000], [0, 0, 0], "tensor_core"),
        (torch.float32, 64, [65536, 1024, 64], [0, 4096, 8192], "cuda_core"),
        (torch.float16, 64, [65536, 1024, 64], [0, 0, 0], "cuda_core"),
        (torch.bfloat16, 8, [8, 8, 8], [0, 0, 0], "cuda_core"),
        (torch.bfloat16, 24, [24, 48, 96], [0, 0, 0], "cuda_core"),
        (torch.bfloat16, 144, [144, 288, 576], [0, 0, 0], "cuda_core"),
        (torch.bfloat16, 64, [65536, 1028, 64], [0, 0, 0], "cuda_core"),
        (torch.bfloat16, 64, [65536, 1024, 64], [0, 8, 0], "cuda_core"),
    ],
)
def test_select_variant(dtype, D, strides, ptrs, want):
    assert select_variant(dtype, D, strides, ptrs) == want


def test_variant_for_tensors():
    q = torch.zeros(2, 70, 4, 64, dtype=torch.bfloat16)
    assert variant_for(q, q, q) == "tensor_core"
    assert variant_for(q.float(), q.float(), q.float()) == "cuda_core"
    assert variant_for(q[..., :8], q[..., :8], q[..., :8]) == "cuda_core"  # D = 8
    # a (B, H, S, D) tensor viewed as (B, S, H, D): strides still 16-byte multiples
    qt = torch.zeros(2, 4, 70, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert variant_for(qt, qt, qt) == "tensor_core"
    # a base pointer off the 16-byte grid
    flat = torch.zeros(1 + 2 * 70 * 4 * 64, dtype=torch.bfloat16)
    off = flat[1:].view(2, 70, 4, 64)
    assert variant_for(off, q, q) == "cuda_core"
    # a row stride that is not a multiple of 8 elements
    wide = torch.zeros(2, 70, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert variant_for(wide, wide, wide) == "cuda_core"
    # a dimension of size 1 is never stepped over: its stride does not count
    one = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16).as_strided((1, 1, 4, 64), (3, 5, 64, 1))
    assert variant_for(one, one, one) == "tensor_core"


def test_variant_keyword():
    q = torch.randn(1, 40, 2, 16).to(torch.bfloat16)
    base = flash_attention(q, q, q)  # a CPU tensor: the plain version, any variant
    for variant in ("auto", "tensor_core", "cuda_core"):
        assert torch.equal(flash_attention(q, q, q, variant=variant), base)
    with pytest.raises(ValueError, match="unknown variant"):
        flash_attention(q, q, q, variant="wgmma")


@pytest.mark.parametrize(
    "case", [c for c in CASES if c["D"] % 16 == 0], ids=lambda c: f"D{c['D']}-Sq{c['Sq']}"
)
def test_tc_emulation_matches_jax_flash(case):
    """On JAX's cases that the rule sends to the tensor cores."""
    q, k, v = bf16_inputs(case, 0)
    assert variant_for(q, k, v) == "tensor_core"
    kw = dict(causal=case["causal"], window=case["window"])
    got = tc_emulation(q, k, v, **kw, p_terms=P_TERMS)
    assert one_step_bad(got, jax_out(q, k, v, **kw)) == 0


def cancelling_inputs(Sk=200, H=4, D=64, seed=7):
    """One query per head over Sk keys whose last value cancels the others:
    v[last] = bf16(-sum_{j < last} p_j v_j / p_last), so every output is a
    bf16 rounding residue, far smaller than the terms p_j v_j."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, Sk, H, D)).astype(np.float32))
    k[0, -1] = 0.5 * q[0, 0]  # the last key scores highest
    v = torch.from_numpy(rng.standard_normal((1, Sk, H, D)).astype(np.float32))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    s = torch.einsum("hd,khd->hk", q[0, 0].double(), k[0].double()) / math.sqrt(D)
    p = torch.exp(s - s.amax(-1, keepdim=True))  # (H, Sk)
    rest = torch.einsum("hk,khd->hd", p[:, :-1], v[0, :-1].double())
    v[0, -1] = (-rest / p[:, -1:]).to(torch.bfloat16)
    return q, k, v


def test_p_terms_on_cancelling_outputs():
    q, k, v = cancelling_inputs()
    want = jax_out(q, k, v, causal=True, window=None)
    terms = v[0, :-1].float().abs().mean()
    assert want.abs().median() < 0.02 * terms  # the outputs do cancel
    assert one_step_bad(tc_emulation(q, k, v, causal=True, window=None, p_terms=P_TERMS), want) == 0
    # P rounded to bf16 alone puts ~2^-9 of the terms into every output
    assert one_step_bad(tc_emulation(q, k, v, causal=True, window=None, p_terms=1), want) > 0
