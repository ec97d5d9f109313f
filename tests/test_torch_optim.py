"""The port's AdamW against the JAX package's, on the CPU.

* ``adamw_update`` leaf for leaf against JAX's over 3 steps on one tree of
  bf16 and f32 leaves (dicts and a list), the first step's gradient clipped
  (its global norm far above ``clip_norm``), the others not: the f32 leaves
  and moments within 1e-6 of their largest entry (other ``pow``/``sqrt``
  implementations, the same rounding points), a bf16 leaf within one bf16
  step (2^-8 relative) of JAX's, the step, grad norm and lr within 1e-6;
* ``cosine_schedule`` and ``global_norm`` against JAX's over a range of
  steps;
* the ports of JAX's ``tests/test_optim.py``: a quadratic converges,
  clipping reports the pre-clip norm, the schedule's shape, f32 moments for
  bf16 parameters, the global norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.optim import OptState, adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim.adamw import tree_leaves, tree_map

F32_TOL = 1e-6
BF16_STEP = 2.0**-8


def _tree(rng):
    return {
        "blocks": {"w": rng.standard_normal((3, 4, 5)), "ln": 1 + 0.1 * rng.standard_normal((3, 5))},
        "embed": rng.standard_normal((7, 5)),
        "tail": [{"a": rng.standard_normal((5,))}, {"a": rng.standard_normal((2, 5))}],
        "router": rng.standard_normal((5, 3)),
    }


BF16 = {"blocks.w", "embed"}  # the other leaves are f32, as norms and routers are


def _leaf_dtypes(tree, path=""):
    if isinstance(tree, dict):
        return {k: _leaf_dtypes(v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_dtypes(v, f"{path}{i}.") for i, v in enumerate(tree)]
    return "bfloat16" if path[:-1] in BF16 else "float32"


def _as(tree, dtypes, to):
    if isinstance(tree, dict):
        return {k: _as(v, dtypes[k], to) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, d, to) for v, d in zip(tree, dtypes)]
    a = np.asarray(tree, np.float32)
    if to == "jax":
        return jnp.asarray(a, jnp.dtype(dtypes))
    return torch.from_numpy(a).to(getattr(torch, dtypes))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def test_adamw_update_matches_jax_leaf_for_leaf():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    dtypes = _leaf_dtypes(params)
    jp, tp = _as(params, dtypes, "jax"), _as(params, dtypes, "torch")
    jo, to = jax_adamw.adamw_init(jp), adamw_init(tp)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6)
    for step in range(3):
        g = tree_map(lambda a: a * (1e3 if step == 0 else 0.3), _tree(rng))
        jg, tg = _as(g, dtypes, "jax"), _as(g, dtypes, "torch")
        jp, jo, js = jax_adamw.adamw_update(jp, jg, jo, **kw)
        tp, to, ts = adamw_update(tp, tg, to, **kw)
        if step == 0:
            assert float(js["grad_norm"]) > 1e2  # clipped
        for key in ("grad_norm", "lr"):
            assert abs(float(ts[key]) - float(js[key])) <= F32_TOL * abs(float(js[key]))
        assert int(to.step) == int(jo.step) == step + 1 and to.step.dtype == torch.int32
        for want, got in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert got.dtype == getattr(torch, str(want.dtype))
            w, o = _np(want), _np(got)
            tol = BF16_STEP if want.dtype == jnp.bfloat16 else F32_TOL
            assert np.abs(o - w).max() <= tol * np.abs(w).max()
        for jm, tm in ((jo.m, to.m), (jo.v, to.v)):
            for want, got in zip(jax.tree.leaves(jm), tree_leaves(tm)):
                assert got.dtype == torch.float32
                assert np.abs(_np(got) - _np(want)).max() <= F32_TOL * np.abs(_np(want)).max()


@pytest.mark.parametrize("warmup,total", [(10, 100), (100, 16), (0, 5)])
def test_schedule_and_norm_match_jax(warmup, total):
    for step in (0, 1, 3, 9, 10, 11, 50, 100, 120):
        want = float(jax_adamw.cosine_schedule(jnp.int32(step), peak_lr=3e-4,
                                               warmup_steps=warmup, total_steps=total))
        got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), peak_lr=3e-4,
                                    warmup_steps=warmup, total_steps=total))
        assert abs(got - want) <= F32_TOL * max(abs(want), 1e-12)
    rng = np.random.default_rng(warmup)
    tree = _tree(rng)
    want = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(tree_map(torch.from_numpy, tree)))
    assert abs(got - want) <= F32_TOL * want


def test_state_is_a_named_tuple_of_step_m_v():
    opt = adamw_init({"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert isinstance(opt, OptState) and opt._fields == jax_adamw.OptState._fields
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0


# -- ports of tests/test_optim.py --------------------------------------------------


def test_quadratic_converges():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    loss = lambda p: torch.sum(p["w"] ** 2)  # noqa: E731
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, opt, _ = adamw_update(params, g, opt, peak_lr=0.05, warmup_steps=10,
                                      total_steps=300, weight_decay=0.0)
    assert float(loss(params)) < 1e-2


def test_clipping():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    _, _, stats = adamw_update(params, huge, opt, clip_norm=1.0)
    assert float(stats["grad_norm"]) > 1e8  # reported pre-clip


def test_schedule_shape():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    s0 = cosine_schedule(torch.tensor(0, dtype=torch.int32), **kw)
    s10 = cosine_schedule(torch.tensor(10, dtype=torch.int32), **kw)
    s100 = cosine_schedule(torch.tensor(100, dtype=torch.int32), **kw)
    assert float(s0) == 0.0
    assert abs(float(s10) - 1.0) < 1e-6
    assert 0.0 < float(s100) <= 0.11  # decays to final_frac * peak


def test_moments_dtype_fp32():
    params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.m["w"].dtype == torch.float32
    g = {"w": torch.ones(3, dtype=torch.bfloat16)}
    p2, opt2, _ = adamw_update(params, g, opt)
    assert p2["w"].dtype == torch.bfloat16
    assert opt2.v["w"].dtype == torch.float32


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6
