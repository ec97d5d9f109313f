"""Public entry points of the WKV6 recurrence.

The port of ``repro/kernels/wkv6/ops.py``.  ``wkv6_op`` defaults to the
hand-written kernel, where the JAX package defaults to ``"ref"`` (on the
TPU no entry point ever selected ``"pallas"``); ``"ref"`` stays as the named
plain version.  The kernel runs the recurrence in time order, so the JAX
wrapper's padding of T to a chunk multiple is gone.  ``wkv6_decode_step``
is the single-token form of the decode path (plain torch, as in the JAX
package).

The kernel has no backward of its own.  ``WKV6``, the autograd Function
that ``wkv6_op(impl="kernel")`` goes through when grad mode is on and an
input requires grad, launches the kernel forward and saves only its
inputs; its backward recomputes the kernel's plain version (``wkv6_ref`` on
the decays clipped to [1e-30, 1], the kernel's function) under autograd and
returns that gradient, for the output and the final state alike (an
initial state that requires grad gets one too).  It is the gradient JAX
takes: the JAX package trains through ``"ref"``.  The plain backward loops
over T in Python.  Under ``no_grad`` or ``inference_mode`` the kernel is
called directly.  On ``meta`` tensors (the dry run) the backward is shapes
only, its FLOPs by formula (``_meta_backward``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.wkv6.kernel import FLOPS_BACKWARD, wkv6
from repro_torch.kernels.wkv6.ref import wkv6_ref


def _plain(r, k, v, decay, u, initial_state):
    return wkv6_ref(r, k, v, decay.clamp(1e-30, 1.0), u, initial_state)


def _meta_backward(saved):
    """The gradient's shapes (:mod:`repro_torch.kernels.meta`), its FLOPs
    by formula: the plain backward's loop over T is not traced."""
    r, v = saved[0], saved[2]
    B, T, H, K = r.shape
    with meta.fused("wkv6.backward", (*saved,),
                    flops=FLOPS_BACKWARD * B * T * H * K * v.shape[3]) as outputs:
        outputs += [None if t is None else torch.empty_like(t) for t in saved]
    return tuple(outputs)


class WKV6(torch.autograd.Function):
    """``wkv6`` forward; the gradient of its plain version."""

    @staticmethod
    def forward(ctx, r, k, v, decay, u, initial_state):
        ctx.save_for_backward(r, k, v, decay, u, initial_state)
        return wkv6(r, k, v, decay, u, initial_state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        saved = ctx.saved_tensors
        if saved[0].device.type == "meta":
            return _meta_backward(saved)
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(True) for t in saved]
            out, state = _plain(*inputs)
            wrt = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad((out, state), wrt, (g_out, g_state)))
        return tuple(None if t is None else next(grads) for t in inputs)


def wkv6_op(r, k, v, decay, u, initial_state=None, *, impl: str = "kernel"):
    """(B, T, H, K/V) inputs -> (out, final_state).  impl: 'kernel' | 'ref'.
    The kernel goes through ``WKV6`` when a gradient is to be taken."""
    if impl == "kernel":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (r, k, v, decay, u, initial_state)):
            return WKV6.apply(r, k, v, decay, u, initial_state)
        return wkv6(r, k, v, decay, u, initial_state)
    if impl == "ref":
        return wkv6_ref(r, k, v, decay, u, initial_state)
    raise ValueError(f"unknown wkv6 impl {impl!r}; known: kernel, ref")


def wkv6_decode_step(r_t, k_t, v_t, d_t, u, state):
    """One decode token: r_t/k_t/d_t (B, H, K), v_t (B, H, V),
    state (B, H, K, V) -> (o_t (B, H, V), new_state)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r_t, state + u[None, :, :, None] * kv)
    new_state = d_t[..., :, None] * state + kv
    return o, new_state
