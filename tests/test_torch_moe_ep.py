"""The port's expert-parallel MoE route against JAX's ``_moe_shard_map``.

``models/moe.py``'s ``moe_apply_ep`` runs one MoE layer on a (data D,
model M) grid of 4 gloo ranks on the CPU (``launch/mesh.py``'s
``ExpertMesh``): each rank holds E/M experts and its data row's tokens,
and one SUM over the model ranks gives the output.  It is held, on the
(1, 4) and (2, 2) grids of a cut qwen3-moe (d 64, 8 experts top-2, f32), to

* JAX's ``_moe_shard_map`` on the same grid of 4 forced host devices
  (``rules_for_mesh(mesh, {"_moe_impl": "shard_map"})``), run in a
  subprocess (XLA_FLAGS must be set before jax starts), at the config's
  capacity factor 1.25 (both round C up: drops included) and at E/K;
* the port's one-process ``moe_apply`` (G = 1) at ample capacity (cf =
  E/K: the routes round C differently, ROADMAP §3, and agree where none
  drops);

output and aux loss within 1e-5 relative in f32.  A grid whose model ranks
do not divide the experts raises (JAX drops back to gspmd; a rank holding
E/M experts cannot).  Through ``launch.serve_lm``'s expert-parallel entry
point, a cut qwen3-moe's greedy tokens equal the one-process ones at cf =
E/K.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_jobs as jobs
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import dry_expert_mesh, spawn_mesh
from repro_torch.models.convert import expert_shard, numpy_params
from repro_torch.models.moe import MoE, moe_apply, moe_apply_ep

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
TOL = 1e-5
GRIDS = [(1, 4), (2, 2)]
B, S = 4, 8


def _cfg(cf):
    base = get_smoke_config("qwen3_moe_235b_a22b")
    return dataclasses.replace(base, capacity_factor=cf if cf else base.n_experts / base.top_k)


CFS = {"cf1.25": 1.25, "cfE/K": None}


def _model(cfg, seed=3):
    """(the model's JAX tree, block 0's MoE leaves, x (B, S, d))."""
    tree = numpy_params(cfg, seed)
    layer = {k: v[0] for k, v in tree["blocks"]["moe"].items()}
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return tree, layer, x


_JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh_compat
from repro.models import moe
from repro.models.sharding import rules_for_mesh

inp, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = dict(np.load(inp))
res = {}
for label, cf, grid in cases:
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"), capacity_factor=cf)
    mesh = make_mesh_compat(tuple(grid), ("data", "model"))
    rules = rules_for_mesh(mesh, {"_moe_impl": "shard_map"})
    p = {k: jnp.asarray(data[k]) for k in ("router", "w1", "w3", "w2")}
    calls = []
    orig = moe._moe_shard_map
    moe._moe_shard_map = lambda *a, **k: calls.append(1) or orig(*a, **k)
    o, aux = moe.moe_apply(cfg, p, jnp.asarray(data["x"]), rules)
    moe._moe_shard_map = orig
    assert calls, "JAX did not take _moe_shard_map"
    res[f"{label}/out"] = np.asarray(o)
    res[f"{label}/aux"] = np.asarray(aux)
np.savez(out, **res)
"""


def _label(cf_name, grid):
    return f"{cf_name}/{grid[0]}x{grid[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs, the port's rank results), run side by side."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    tree, layer, x = _model(_cfg(1.25))
    np.savez(tmp / "in.npz", x=x, **layer)
    jax_cases = [[_label(n, g), _cfg(cf).capacity_factor, list(g)]
                 for n, cf in CFS.items() for g in GRIDS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"),
         json.dumps(jax_cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        cases = [(_label(n, g), _cfg(cf), tree, x, g) for n, cf in CFS.items() for g in GRIDS]
        port = spawn_mesh(jobs.moe_ep, 4, device="cpu", timeout_s=TIMEOUT_S, args=(cases,))
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    with np.load(tmp / "out.npz") as f:
        return dict(f), port, layer, x


def _assembled(port, label, grid):
    """The whole (B, S, d) output from the ranks' blocks (every model rank
    of a data row holds the row's summed output) and the aux losses."""
    D, M = grid
    ranks = [r[label] for r in port]
    for r in ranks:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    rows = {}
    for d, m, out, aux, _ in ranks:
        rows.setdefault(d, []).append(out)
    for d, outs in rows.items():  # the model ranks of a row agree exactly
        assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    return np.concatenate([rows[d][0] for d in range(D)]), [r[3] for r in ranks]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("cf_name", list(CFS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ep_equals_jax_shard_map(runs, grid, cf_name):
    want, port, _, _ = runs
    label = _label(cf_name, grid)
    out, auxes = _assembled(port, label, grid)
    assert _rel(out, want[f"{label}/out"]) <= TOL
    for aux in auxes:  # the same on every rank
        assert abs(aux - float(want[f"{label}/aux"])) <= TOL * abs(float(want[f"{label}/aux"]))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ep_equals_one_process_route_at_ample_capacity(runs, grid):
    _, port, layer, x = runs
    cfg = _cfg(None)
    out, auxes = _assembled(port, _label("cfE/K", grid), grid)
    p = MoE(cfg, device="cpu")
    with torch.no_grad():
        for k, v in layer.items():
            getattr(p, k).copy_(torch.from_numpy(v))
        want, aux = moe_apply(cfg, p, torch.from_numpy(x))
    assert _rel(out, want.numpy()) <= TOL
    assert all(abs(a - float(aux)) <= TOL * abs(float(aux)) for a in auxes)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ep_layer_issues_one_model_sum_and_two_data_reductions(runs, grid):
    """A layer's collectives on every rank: the counts' SUM and the mean
    probabilities' mean over the data ranks, the output's SUM over the
    model ranks, (Tg, d) f32, counted ×2 as all-reduces."""
    _, port, _, x = runs
    D, M = grid
    E, d = _cfg(None).n_experts, x.shape[2]
    Tg = B * S // D
    for r in port:
        coll = r[_label("cfE/K", grid)][4]
        assert coll["counts"]["all-reduce"] == 3
        assert coll["all-reduce"] == 2 * 4 * (E + E + Tg * d)


@pytest.mark.parametrize("M", [3, 5])
def test_model_ranks_that_do_not_divide_the_experts_raise(M):
    cfg = _cfg(None)
    _, _, x = _model(cfg)
    p = MoE(cfg, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        moe_apply_ep(cfg, p, torch.from_numpy(x), dry_expert_mesh(1, M, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        expert_shard(numpy_params(get_smoke_config("qwen3_moe_235b_a22b"), 0), 0, M)


def test_expert_shard_cuts_every_bank_and_keeps_the_router():
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    tree = numpy_params(cfg, 0)
    cut = expert_shard(tree, 1, 4)
    moe, whole = cut["blocks"]["moe"], tree["blocks"]["moe"]
    E4 = cfg.n_experts // 4
    for k in ("w1", "w3", "w2"):
        np.testing.assert_array_equal(moe[k], whole[k][:, E4:2 * E4])
    assert moe["router"] is whole["router"]
    assert cut["embed"] is tree["embed"]


def test_greedy_tokens_through_the_entry_point_equal_one_process():
    from repro_torch.launch.serve_lm import greedy_decode
    from repro_torch.models.registry import get_model

    cfg = _cfg(None)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, 6))
    spec = dict(cfg=cfg, seed=0, prompts=prompts, gen=4, data_ranks=2, expert_ranks=2)
    ranks = spawn_mesh(jobs.serve_ep, 4, device="cpu", timeout_s=TIMEOUT_S, args=(spec,))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    pt = torch.from_numpy(prompts)
    with torch.inference_mode():
        logits = model.forward(params, {"tokens": pt})
        want, _ = greedy_decode(model, params, pt, 4)
    for r in ranks:
        d = r["data_rank"]
        rows = slice(d * B // 2, (d + 1) * B // 2)
        assert r["tokens"] == want[rows].tolist()
        assert _rel(r["last_logits"], logits[rows, -1].numpy()) <= TOL
        assert r["prefill"]["collectives"]["counts"]["all-reduce"] == 3 * cfg.n_layers
