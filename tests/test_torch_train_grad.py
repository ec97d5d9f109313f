"""The LM kernels under autograd, on the CPU.

``attention_op(impl="kernel")`` and ``wkv6_op(impl="kernel")`` go through
the autograd Functions ``FlashAttention`` and ``WKV6`` when a gradient is to
be taken: the kernel forward (on the CPU its plain version), the gradient of
the plain version.  Here:

* each Function's gradient equals autograd through the kernel's plain
  version exactly (the same arithmetic), over GQA, a window, one query,
  non-causal and head size 256, in f32 and bf16, and the wkv6 recurrence
  with and without an initial state that requires grad, its final state in
  the loss or not;
* in f32 it is JAX's gradient through its plain paths (``jax.grad`` of
  ``blockwise_attention`` and ``wkv6_ref``) within 1e-5 of each input's
  largest entry;
* under ``no_grad`` and ``inference_mode`` the kernel is called directly
  (no Function, no saved tensors);
* no silent drop: through a whole smoke model, the attention weights
  (``wq``/``wk``/``wv``/``wo`` and the QKV biases) and RWKV6's time-mix
  weights get nonzero gradients equal to those of the plain route
  (``attn_impl="blockwise"``, ``wkv_impl="ref"``) within 1e-5 (f32; the
  kernel's plain version and the blockwise route differ in key block
  size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels.flash_attention import blockwise_attention as jax_blockwise
from repro.kernels.wkv6 import wkv6_ref as jax_wkv6_ref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_plain
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.wkv6.ops import wkv6_op
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models import rwkv6, transformer
from repro_torch.models.convert import load_jax_params, numpy_params
from repro_torch.models.registry import get_model

JAX_TOL = 1e-5
PLAIN_TOL = 1e-5

ATTN = [
    dict(B=2, Sq=64, Sk=64, Hq=4, Hkv=2, D=32, causal=True, window=None),
    dict(B=1, Sq=70, Sk=70, Hq=4, Hkv=1, D=64, causal=True, window=32),
    dict(B=2, Sq=1, Sk=45, Hq=8, Hkv=4, D=32, causal=True, window=None),
    dict(B=1, Sq=50, Sk=50, Hq=2, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=40, Sk=40, Hq=4, Hkv=1, D=256, causal=True, window=24),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=2, D=256, causal=False, window=None),
]


def _attn_inputs(c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f(c["B"], c["Sq"], c["Hq"], c["D"])
    k, v = f(c["B"], c["Sk"], c["Hkv"], c["D"]), f(c["B"], c["Sk"], c["Hkv"], c["D"])
    return q, k, v, f(c["B"], c["Sq"], c["Hq"], c["D"])


def _leaves(arrs, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrs]


@pytest.mark.parametrize("case", ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_gradient_is_the_plain_gradient(case, dtype):
    q, k, v, w = _attn_inputs(case, 0)
    mask = dict(causal=case["causal"], window=case["window"])
    a = _leaves((q, k, v), dtype)
    out = attention_op(*a, impl="kernel", **mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    wt = torch.from_numpy(w).to(dtype)
    got = torch.autograd.grad((out * wt).sum(), a)
    b = _leaves((q, k, v), dtype)
    want = torch.autograd.grad((flash_attention_plain(*b, **mask) * wt).sum(), b)
    for g, t in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, t)
    if dtype == torch.float32:
        jg = jax.grad(lambda q, k, v: jnp.sum(jax_blockwise(q, k, v, **mask) * w),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for g, j in zip(got, jg):
            j = np.asarray(j)
            assert np.abs(g.numpy() - j).max() <= JAX_TOL * np.abs(j).max()


def _wkv_inputs(B, T, H, K, V, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k = f(B, T, H, K) * 0.5, f(B, T, H, K) * 0.5
    v = f(B, T, H, V)
    decay = np.exp(-np.exp(rng.uniform(-3, 1, (B, T, H, K)))).astype(np.float32)
    return r, k, v, decay, f(H, K) * 0.5, f(B, H, K, V) * 0.1


@pytest.mark.parametrize("with_state,state_in_loss", [(False, False), (True, False),
                                                      (True, True), (False, True)])
def test_wkv6_function_gradient_is_the_plain_gradient(with_state, state_in_loss):
    arrs = _wkv_inputs(2, 19, 3, 8, 8, int(with_state) + 2 * int(state_in_loss))
    rng = np.random.default_rng(7)
    wo = torch.from_numpy(rng.standard_normal((2, 19, 3, 8)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))

    def loss(out, state):
        return (out * wo).sum() + ((state * ws).sum() if state_in_loss else 0)

    def run(fn):
        t = _leaves(arrs if with_state else arrs[:5], torch.float32)
        out, state = fn(*t)
        return out, state, torch.autograd.grad(loss(out, state), t)

    out, state, got = run(lambda *t: wkv6_op(*t, impl="kernel"))
    assert type(out.grad_fn).__name__ == "WKV6Backward" and state.requires_grad
    _, _, want = run(lambda r, k, v, d, u, s0=None: wkv6_ref(r, k, v, d.clamp(1e-30, 1.0), u, s0))
    for g, t in zip(got, want):
        assert torch.equal(g, t)

    def jloss(*a):
        out, state = jax_wkv6_ref(*a)
        return jnp.sum(out * wo.numpy()) + (jnp.sum(state * ws.numpy()) if state_in_loss else 0)

    inputs = [jnp.asarray(a) for a in (arrs if with_state else arrs[:5])]
    jg = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*inputs)
    for g, j in zip(got, jg):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= JAX_TOL * np.abs(j).max()


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_without_grad_the_kernel_is_called_directly(mode):
    q, k, v, _ = _attn_inputs(ATTN[0], 1)
    a = _leaves((q, k, v), torch.float32)
    r, kk, vv, d, u, s0 = _leaves(_wkv_inputs(1, 5, 2, 4, 4, 1), torch.float32)
    with mode():
        out = attention_op(*a, impl="kernel")
        o, st = wkv6_op(r, kk, vv, d, u, s0, impl="kernel")
    assert out.grad_fn is None and o.grad_fn is None and st.grad_fn is None
    # and with no input requiring grad, grad mode on
    out = attention_op(*(t.detach() for t in a), impl="kernel")
    assert out.grad_fn is None


def _grads(loss_fn, params, batch, **kw):
    named = dict(params.named_parameters())
    loss = loss_fn(params, batch, **kw)
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch,loss_fn,plain,weights", [
    ("qwen1_5_0_5b", transformer.loss_fn, dict(attn_impl="blockwise"),
     ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "attn.bq", "attn.bk", "attn.bv")),
    ("rwkv6_3b", rwkv6.loss_fn, dict(wkv_impl="ref"),
     ("tmix.wr", "tmix.wk", "tmix.wv", "tmix.wg", "tmix.wa", "tmix.wb", "tmix.w0",
      "tmix.u", "tmix.mu")),
])
def test_no_silent_drop_of_kernel_gradients(arch, loss_fn, plain, weights):
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = load_jax_params(model.init(device="cpu"), numpy_params(cfg, 5))
    batch = _batch(cfg)
    got = _grads(loss_fn, params, batch)
    want = _grads(loss_fn, params, batch, **plain)
    checked = 0
    for name, g in got.items():
        if not name.endswith(weights):
            continue
        w = want[name]
        assert float(g.abs().max()) > 0, name
        assert float((g - w).abs().max()) <= PLAIN_TOL * float(w.abs().max()), name
        checked += 1
    assert checked == cfg.n_layers * len(weights)
