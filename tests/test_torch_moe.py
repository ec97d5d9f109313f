"""The port's MoE block against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_apply`` against JAX's ``moe_apply(cfg, p, x,
rules=None)`` (the grouped dispatch with one group, the serving path's
route) on seeded numpy weights and inputs in f32, over (E, K, cf) in
{(8, 2, 1.25), (4, 1, 1.25), (8, 2, 0.1), (128, 8, 1.25)} at d 32:

* the routing decisions exactly: the top-k expert ids, the keep mask (which
  assignments fit under the capacity C) and the dropped count, with JAX's
  own ``top_k``, stable ``argsort`` and keep mask captured from inside its
  ``moe_apply``;
* ``out`` and ``aux`` within 1e-5;
* the ports of JAX's ``tests/test_moe.py`` cases: the manual two-expert
  routing and no NaN at cf = 0.1.  Its ``test_grad_flows`` waits with
  training (ROADMAP queue 1, item 14f).

A routing choice is exact only where no float difference can flip it, so
each case asserts a margin: the smallest gap between a token's K-th and
(K+1)-th probability is above 1e-4, far above the ~1e-7 by which the two
packages' f32 probabilities may differ.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import moe as jax_moe
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import counts
from repro_torch.models import moe


@pytest.fixture(autouse=True)
def _serving_without_grad():
    """Serving runs without autograd; the parameters require grad."""
    with torch.no_grad():
        yield


D, F = 32, 16
TOL = 1e-5
MARGIN = 1e-4
# (E, K, cf, x shape, seed).  (8, 2, 0.1) gives C = 1: most assignments
# drop.  At (128, 8) the top-8 of 128 probabilities lie close together: of
# seeds 0-7 at 16 tokens only 2 and 5 keep every gap above 1e-4 (the others'
# smallest gaps are 5.0e-7 to 2.8e-5), so the case runs seed 2 (C = 1).  At
# (4, 1) seed 4 would fall under it too (4.8e-5); seed 0 is used.
CASES = [
    (8, 2, 1.25, (4, 16), 0),
    (4, 1, 1.25, (4, 16), 0),
    (8, 2, 0.1, (2, 16), 1),
    (128, 8, 1.25, (2, 8), 2),
]


def cfgs(E, K, cf):
    kw = dict(name=f"moe-test-{E}-{K}-{cf}", family="moe", n_layers=1, d_model=D,
              n_heads=2, n_kv_heads=2, d_ff=F, vocab=64, n_experts=E, top_k=K,
              capacity_factor=cf, dtype="float32")
    return JaxModelConfig(**kw), ModelConfig(**kw)


def weights(E, seed):
    """JAX's ``moe_init`` scales, drawn by numpy."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) * D**-0.5,
         "w1": rng.standard_normal((E, D, F)) * D**-0.5,
         "w3": rng.standard_normal((E, D, F)) * D**-0.5,
         "w2": rng.standard_normal((E, F, D)) * F**-0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


def port_moe(cfg, tree) -> moe.MoE:
    m = moe.MoE(cfg, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    return m


class _Spy:
    """Forwards attribute lookups to ``target``; the calls named in
    ``record`` append (args, result) to ``log[name]``."""

    def __init__(self, target, record, log, **attrs):
        self._target, self._record, self._log, self._attrs = target, record, log, attrs

    def __getattr__(self, name):
        if name in self._attrs:
            return self._attrs[name]
        attr = getattr(self._target, name)
        if name not in self._record:
            return attr

        def call(*a, **kw):
            out = attr(*a, **kw)
            self._log.setdefault(name, []).append((a, out))
            return out

        return call


def jax_moe_captured(cfg, tree, x):
    """JAX's ``moe_apply(rules=None)`` -> (out, aux, top_e (T, K), keep
    (T, K) by token), its top_k, argsort and keep mask taken from the call
    itself (``moe.py``'s module globals ``jax`` and ``jnp``, spied)."""
    log = {}
    lax = _Spy(jax.lax, {"top_k"}, log)
    with mock.patch.object(jax_moe, "jax", _Spy(jax, (), log, lax=lax)), \
            mock.patch.object(jax_moe, "jnp", _Spy(jnp, {"argsort", "where"}, log)):
        out, aux = jax_moe.moe_apply(cfg, {k: jnp.asarray(v) for k, v in tree.items()},
                                     jnp.asarray(x), rules=None)
    top_e = np.asarray(log["top_k"][0][1][1])[0]  # (G=1, T, K)
    order = np.asarray(log["argsort"][0][1])[0]
    # the first jnp.where is slot = where(keep, e * C + pos, E * C)
    keep_sorted = np.asarray(log["where"][0][0][0])[0]
    keep = np.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return np.asarray(out), float(aux), top_e, keep.reshape(top_e.shape)


def routing_margin(tree, x, K) -> float:
    """The smallest gap between a token's K-th and (K+1)-th router
    probability, in f64."""
    logits = x.reshape(-1, D).astype(np.float64) @ tree["router"].astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, K - 1] - p[:, K]).min())


@pytest.mark.parametrize("E,K,cf,shape,seed", CASES)
def test_moe_apply_matches_jax(E, K, cf, shape, seed):
    jcfg, cfg = cfgs(E, K, cf)
    tree = weights(E, seed)
    x = np.random.default_rng(100 + seed).standard_normal((*shape, D)).astype(np.float32)
    assert routing_margin(tree, x, K) > MARGIN
    want, want_aux, want_e, want_keep = jax_moe_captured(jcfg, tree, x)

    p = port_moe(cfg, tree)
    xt = torch.from_numpy(x)
    r = moe.route(cfg, p, xt)
    T = shape[0] * shape[1]
    assert r["C"] == int(max(1, (K * T / E) * cf))  # repro/models/moe.py:129
    assert (r["top_e"].numpy() == want_e).all()
    keep = moe.keep_by_token(r).numpy()
    assert (keep == want_keep).all()
    assert int((~keep).sum()) == int((~want_keep).sum())
    assert int(r["counts"].sum()) == T * K

    counts.reset()
    out, aux = moe.moe_apply(cfg, p, xt)
    assert counts.snapshot() == {}
    assert out.shape == x.shape and out.dtype == torch.float32
    assert float(np.abs(out.numpy() - want).max()) < TOL
    assert abs(float(aux) - want_aux) < TOL


def test_capacity_cases_drop_as_intended():
    """The cases cover every capacity regime: drops at (8, 2, 0.1) and at
    (128, 8) (C = 1), some or none at cf 1.25 with 64 tokens."""
    dropped = {}
    for E, K, cf, shape, seed in CASES:
        _, cfg = cfgs(E, K, cf)
        x = np.random.default_rng(100 + seed).standard_normal((*shape, D)).astype(np.float32)
        r = moe.route(cfg, port_moe(cfg, weights(E, seed)), torch.from_numpy(x))
        dropped[(E, K, cf)] = int((~r["keep"]).sum())
    assert dropped[(8, 2, 0.1)] > 32 and dropped[(128, 8, 1.25)] > 0


def test_manual_two_expert_routing():
    """JAX's test_manual_two_expert_routing: a router that sends feature-0
    < 0 tokens to expert 0, else to expert 1, against a hand SwiGLU."""
    _, cfg = cfgs(2, 1, 8.0)
    tree = weights(2, 0)
    tree["router"] = np.zeros((D, 2), np.float32)
    tree["router"][0] = (-100.0, 100.0)
    p = port_moe(cfg, tree)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 6, D)).astype(np.float32))
    out, _ = moe.moe_apply(cfg, p, x)
    eid = (x[0, :, 0] > 0).long()
    want = torch.stack([
        (torch.nn.functional.silu(x[0, t] @ p.w1[e]) * (x[0, t] @ p.w3[e])) @ p.w2[e]
        for t, e in enumerate(eid.tolist())])
    assert float((out[0] - want).abs().max()) < 1e-4


def test_capacity_drops_dont_nan():
    """JAX's test_capacity_drops_dont_nan: cf 0.1, most tokens drop."""
    _, cfg = cfgs(4, 2, 0.1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, D)).astype(np.float32))
    out, aux = moe.moe_apply(cfg, port_moe(cfg, weights(4, 0)), x)
    assert not bool(torch.isnan(out).any()) and bool(torch.isfinite(aux))


def test_combine_order_is_ascending_expert_in_bf16():
    """bf16: each token's K products are added one by one in ascending
    expert order, the order of JAX's sorted scatter updates; the sum equals
    that order's explicit left fold bit for bit, and a second call is
    bitwise equal (no atomics)."""
    _, cfg = cfgs(8, 2, 8.0)
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": "bfloat16"})
    tree = weights(8, 3)
    p = moe.MoE(cfg, device="cpu")
    p.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, D))).to(torch.bfloat16)
    out, _ = moe.moe_apply(cfg, p, x)
    again, _ = moe.moe_apply(cfg, p, x)
    assert torch.equal(out, again)
    r = moe.route(cfg, p, x)
    keep = moe.keep_by_token(r)
    xs = x.reshape(-1, D)
    for t in range(xs.shape[0]):
        acc = torch.zeros(D, dtype=torch.bfloat16)
        for k in r["top_e"][t].argsort().tolist():  # ascending expert
            e = int(r["top_e"][t, k])
            if keep[t, k]:
                h = torch.nn.functional.silu(xs[t : t + 1] @ p.w1[e]) * (xs[t : t + 1] @ p.w3[e])
                acc = acc + (h @ p.w2[e])[0] * r["top_p"][t, k].to(torch.bfloat16)
        assert torch.equal(out.reshape(-1, D)[t], acc), t


def test_profile_lm_splits_device_time_by_moe_range(tmp_path):
    """``launch/profile_lm.py`` gives each device event to the MoE range its
    launch was issued in (by correlation id), the rest to "other", through
    ``launch/profile.py``'s ``range_split``."""
    import json

    from repro_torch.launch.profile import range_split
    from repro_torch.launch.profile_lm import MOE_RANGES

    ev = [
        {"cat": "user_annotation", "name": "moe.route", "ts": 0, "dur": 10},
        {"cat": "user_annotation", "name": "moe.experts", "ts": 20, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 25, "dur": 1,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40, "dur": 1,
         "args": {"correlation": 3}},
        {"cat": "kernel", "name": "a", "ts": 50, "dur": 2000, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "b", "ts": 60, "dur": 3000, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "c", "ts": 70, "dur": 500, "args": {"correlation": 3}},
    ]
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": ev}))
    assert range_split(trace, MOE_RANGES) == {"moe.route": 2.0, "moe.experts": 3.0,
                                              "other": 0.5}
