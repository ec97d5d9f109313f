"""Expert-parallel training of the MoE family against JAX's ``value_and_grad``
through ``_moe_shard_map``, on the CPU.

The port trains on a (data D, model M) grid of 4 gloo ranks
(``launch/mesh.py``'s ``ExpertMesh``): rank (d, m) holds experts [m·E/M,
(m+1)·E/M) of every layer and rows [d·B/D, (d+1)·B/D) of the batch; the MoE
collectives carry JAX's transposes under autograd (``models/moe.py``), the
gradients are averaged over the data ranks and AdamW updates each shard
(``launch/train.py``).  On the smoke qwen3-moe (d 64, 8 experts top-2, 2
layers, f32) at B 4, S 8 it is held, on the (1, 4) and (2, 2) grids, at the
config's capacity factor 1.25 and at E/K, to

* JAX's ``jax.value_and_grad(lambda p: model.loss_fn(p, batch, rules=...))``
  with ``rules_for_mesh(mesh, {"_moe_impl": "shard_map"})`` on the same grid
  of 4 forced host devices, then one ``adamw_update``, jitted under the mesh
  in a subprocess (XLA_FLAGS must be set before jax starts): the loss, every
  gradient leaf (the model ranks' shards assembled), the grad norm and every
  parameter after the step, each within 1e-5 of its leaf's largest entry.
  Each data group rounds its capacity over its own tokens, so at cf 1.25
  the (2, 2) grid drops other assignments than (1, 4): each grid is held to
  JAX on the same grid;
* the port's one-process ``train_step`` at cf = E/K (no drop on either
  route), within 1e-5.

And: one MoE layer's input and router gradients on each rank of the grid
equal the one-process layer's (the fault of the route before its
collectives had transposes: each rank's gradient missed the other model
ranks' parts); after two steps every replicated leaf is bitwise equal on
all ranks and each expert shard on its data column; a batch the data ranks
do not divide raises; the launcher's ``--data-ranks 2 --expert-ranks 2``
prints the grid's ``train_loop`` lines, rank 0 alone; a grid's checkpoint
resumes in one process and the reverse, and an f32 one restores in JAX's
``restore_checkpoint``.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_jobs as jobs
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import store as jax_store
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train
from repro_torch.launch.mesh import dry_expert_mesh, spawn_mesh
from repro_torch.models.convert import export_params, export_tree, load_jax_params, numpy_params
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import init_expert_parallel
from repro_torch.optim import adamw_init

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen3_moe_235b_a22b"
TIMEOUT_S = 240
TOL = 1e-5
GRIDS = [(1, 4), (2, 2)]
B, S = 4, 8
CFS = {"cf1.25": 1.25, "cfE/K": None}
EXPERT = ("blocks.moe.w1", "blocks.moe.w3", "blocks.moe.w2")


def _cfg(cf):
    base = get_smoke_config(ARCH)
    return dataclasses.replace(base, capacity_factor=cf if cf else base.n_experts / base.top_k)


def _batch(seed=0, batch=B):
    pipe = SyntheticTokens(vocab=_cfg(None).vocab, seq_len=S + 1, global_batch=batch, seed=seed)
    return {k: v.numpy() for k, v in pipe.next_batch(device="cpu").items()}


def _label(cf_name, grid):
    return f"{cf_name}/{grid[0]}x{grid[1]}"


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v)  # a copy: a parameter's leaf changes in place
    return out


def _gap(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_JAX_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh_compat
from repro.models import moe
from repro.models.registry import get_model
from repro.models.sharding import rules_for_mesh
from repro.optim.adamw import adamw_init, adamw_update

inp, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = dict(np.load(inp))
tree = {}
for path, a in data.items():
    if path.startswith("param."):
        node = tree
        *heads, last = path[len("param."):].split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(a)
batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
res = {}
for label, cf, grid in cases:
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"), capacity_factor=cf)
    model = get_model(cfg)
    mesh = make_mesh_compat(tuple(grid), ("data", "model"))
    rules = rules_for_mesh(mesh, {"_moe_impl": "shard_map"})
    calls = []
    orig = moe._moe_shard_map
    moe._moe_shard_map = lambda *a, **k: calls.append(1) or orig(*a, **k)

    def step(p):
        loss, grads = jax.value_and_grad(lambda p: model.loss_fn(p, batch, rules=rules))(p)
        new, _, stats = adamw_update(p, grads, adamw_init(p))
        return loss, grads, new, stats["grad_norm"]

    with jax.set_mesh(mesh):
        loss, grads, new, gnorm = jax.jit(step)(tree)
    moe._moe_shard_map = orig
    assert calls, "JAX did not take _moe_shard_map"
    res[f"{label}/loss"] = np.asarray(loss)
    res[f"{label}/gnorm"] = np.asarray(gnorm)
    for kind, t in (("grad", grads), ("param", new)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            name = ".".join(str(k.key) for k in path)
            res[f"{label}/{kind}/{name}"] = np.asarray(leaf)
np.savez(out, **res)
"""


CKPT_LOOP = dict(batch=B, seq=S, seed=1)
# the CLI's run: its defaults (seed 0, lr 3e-4) at the config's capacity factor
CLI_LOOP = dict(steps=3, batch=4, seq=16)


def _layer_case():
    """One MoE layer's weights (block 0 of a tree), its input x and the
    weights w of the loss ``sum(out · w) + aux``, at cf = E/K."""
    cfg = _cfg(None)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, numpy_params(cfg, 3), x, w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's readings, the port's ranks' readings, the weights, the batch),
    JAX's subprocess and the port's ranks run side by side.  The ranks' job
    also runs the checkpoint crossings (a one-process checkpoint written
    first for the grid to resume)."""
    tmp = tmp_path_factory.mktemp("moe_ep_train")
    tree = numpy_params(_cfg(None), 0)
    batch = _batch()
    one_dir, grid_dir = str(tmp / "one"), str(tmp / "grid")
    train.train_loop(_cfg(None), steps=2, ckpt_dir=one_dir, ckpt_every=10**9, device="cpu",
                     **CKPT_LOOP)
    ckpt = dict(cfg=_cfg(None), grid=(2, 2), loop=CKPT_LOOP, first=2, steps=3,
                write_dir=grid_dir, resume_dir=one_dir)
    np.savez(tmp / "in.npz", **batch, **{f"param.{k}": v for k, v in _flat(tree).items()})
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
        cases = [(_label(n, g), _cfg(cf), tree, batch, g) for n, cf in CFS.items() for g in GRIDS]
        cli = dict(cfg=get_smoke_config(ARCH), grid=(2, 2), loop=CLI_LOOP)
        parts = [("train", "moe_ep_train", (cases,)), ("ckpt", "ep_train_checkpoints", (ckpt,)),
                 ("cli", "ep_train_loop", (cli,))]
        ranks = spawn_mesh(jobs.job, 4, device="cpu", timeout_s=TIMEOUT_S, args=(parts,))
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    with np.load(tmp / "out.npz") as f:
        want = dict(f)
    return {"jax": want, "tree": tree, "batch": batch, "ckpt_spec": ckpt,
            **{part: [r[part] for r in ranks] for part in ("train", "ckpt", "cli")}}


def _ranks(runs, label):
    ranks = [r[label] for r in runs["train"]]
    for r in ranks:
        assert "error" not in r, r.get("error")
    return ranks


def _assembled(ranks, leaves, M: int) -> dict:
    """The whole tree from the ranks' ``leaves`` (a reading's tree): the
    expert banks concatenated over the model ranks of data row 0, every
    other leaf rank 0's."""
    row = sorted((r for r in ranks if r["d"] == 0), key=lambda r: r["m"])
    assert len(row) == M
    out = dict(leaves(row[0]))
    for k in EXPERT:
        out[k] = np.concatenate([leaves(r)[k] for r in row], axis=1)
    return out


@pytest.mark.parametrize("cf_name", list(CFS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_equals_jax_value_and_grad_and_adamw(runs, grid, cf_name):
    want = runs["jax"]
    label = _label(cf_name, grid)
    ranks = _ranks(runs, label)
    loss, gnorm = float(want[f"{label}/loss"]), float(want[f"{label}/gnorm"])
    for r in ranks:  # every rank reports the global batch's loss and norm
        assert abs(r["loss"] - loss) <= TOL * abs(loss)
        assert abs(r["steps"][0]["loss"] - loss) <= TOL * abs(loss)
        assert abs(r["steps"][0]["gnorm"] - gnorm) <= TOL * gnorm
    for kind, leaves in (("grad", lambda r: r["grads"]),
                         ("param", lambda r: r["steps"][0]["params"])):
        got = _assembled(ranks, leaves, grid[1])
        prefix = f"{label}/{kind}/"
        names = {k[len(prefix):] for k in want if k.startswith(prefix)}
        assert names == set(got)
        gaps = {k: _gap(got[k], want[prefix + k]) for k in names}
        assert max(gaps.values()) <= TOL, (kind, {k: v for k, v in gaps.items() if v > TOL})
        if kind == "grad":  # every leaf is reached
            assert all(np.abs(want[prefix + k]).max() > 0 for k in names)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_equals_one_process_train_step_at_ample_capacity(runs, grid):
    cfg = _cfg(None)
    model = get_model(cfg)
    params = load_jax_params(model.init(device="cpu"), runs["tree"])
    b = {k: torch.from_numpy(v) for k, v in runs["batch"].items()}
    loss, grads = train.value_and_grad(model, params, b)
    want_grads = _flat(export_tree(params, grads))
    opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
    steps = []
    for _ in range(2):
        opt, l1, g1 = train.train_step(model, params, opt, b, peak_lr=3e-4, total_steps=10_000)
        steps.append((float(l1), float(g1), _flat(export_params(params))))
    ranks = _ranks(runs, _label("cfE/K", grid))
    for r in ranks:
        assert abs(r["loss"] - float(loss)) <= TOL * abs(float(loss))
        for got, (l1, g1, _) in zip(r["steps"], steps):
            assert abs(got["loss"] - l1) <= TOL * abs(l1) and abs(got["gnorm"] - g1) <= TOL * g1
    got = _assembled(ranks, lambda r: r["grads"], grid[1])
    assert max(_gap(got[k], want_grads[k]) for k in want_grads) <= TOL
    for i, (_, _, want) in enumerate(steps):
        got = _assembled(ranks, lambda r: r["steps"][i]["params"], grid[1])
        assert max(_gap(got[k], want[k]) for k in want) <= TOL


@pytest.mark.parametrize("cf_name", list(CFS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_replicated_leaves_bitwise_equal_across_ranks_after_two_steps(runs, grid, cf_name):
    """The model ranks of a row hold bitwise-equal replicated gradients, and
    AdamW keeps every replicated leaf bitwise equal on all D·M ranks; each
    expert shard is bitwise equal on its data column."""
    ranks = _ranks(runs, _label(cf_name, grid))
    first = ranks[0]
    for r in ranks[1:]:
        for k, v in first["steps"][1]["params"].items():
            if k not in EXPERT:
                assert np.array_equal(v, r["steps"][1]["params"][k]), (r["d"], r["m"], k)
        for k, v in first["grads"].items():
            if k not in EXPERT and r["d"] == first["d"]:
                assert np.array_equal(v, r["grads"][k]), (r["d"], r["m"], k)
        assert r["steps"][1]["gnorm"] == first["steps"][1]["gnorm"]
    for r in ranks:
        column = [c for c in ranks if c["m"] == r["m"]]
        for k in EXPERT:
            assert all(np.array_equal(c["steps"][1]["params"][k], r["steps"][1]["params"][k])
                       for c in column)


@pytest.fixture(scope="module")
def layer_ranks():
    """Each grid's ranks' layer gradients (a job of its own: it holds the
    route's collectives alone)."""
    cfg, tree, x, w = _layer_case()
    cases = [(f"{g[0]}x{g[1]}", cfg, tree, x, w, g) for g in GRIDS]
    return spawn_mesh(jobs.moe_ep_layer_grad, 4, device="cpu", timeout_s=TIMEOUT_S,
                      args=(cases,))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_layer_input_and_router_gradients_equal_one_process(layer_ranks, grid):
    """One MoE layer at cf = E/K, the loss ``sum(out · w) + aux``: on each
    rank, its rows' input gradient (over D: a data rank's loss is its share
    scaled as a mean is) and the router gradient averaged over the data
    ranks equal the one-process layer's, the aux loss's path counted once."""
    cfg, tree, x, w = _layer_case()
    p = MoE(cfg, device="cpu")
    with torch.no_grad():
        for k, v in tree["blocks"]["moe"].items():
            getattr(p, k).copy_(torch.from_numpy(v[0]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_apply(cfg, p, xt)
    gx, gr = (t.numpy() for t in torch.autograd.grad(
        torch.sum(out * torch.from_numpy(w)) + aux, (xt, p.router)))
    D, M = grid
    ranks = [r[f"{D}x{M}"] for r in layer_ranks]
    assert all(not isinstance(r, dict) for r in ranks), ranks
    for d, m, rx, _ in ranks:
        rows = slice(d * B // D, (d + 1) * B // D)
        assert _gap(rx / D, gx[rows]) <= TOL, (d, m, _gap(rx / D, gx[rows]))
    for m in range(M):
        mean = sum(r[3] for r in ranks if r[1] == m) / D
        assert _gap(mean, gr) <= TOL, (m, _gap(mean, gr))


def test_batch_the_data_ranks_do_not_divide_raises():
    cfg = _cfg(None)
    with pytest.raises(ValueError, match="do not divide a batch of 3"):
        train.train_loop(cfg, steps=1, batch=3, seq=S, device="cpu",
                         ep=dry_expert_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="do not divide a batch of 3"):
        train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
                    "--data-ranks", "2", "--expert-ranks", "2", "--batch", "3", "--steps", "1"])


def test_expert_leaves_and_the_attached_mesh():
    cfg = _cfg(None)
    params = init_expert_parallel(cfg, dry_expert_mesh(1, 4, device="cpu"), device="cpu")
    assert train.expert_leaves(params) == {f"blocks.{i}.moe.{w}" for i in range(cfg.n_layers)
                                           for w in ("w1", "w3", "w2")}
    assert train.expert_mesh(params) is params.blocks[0].moe.ep
    assert train.expert_mesh(get_model(cfg).init(device="cpu")) is None


_LINE = re.compile(r"\[train\] step +(\d+) loss +([\d.]+) gnorm +([\d.]+)")


def test_cli_grid_prints_the_grid_train_loop_lines(runs):
    """``--data-ranks 2 --expert-ranks 2`` at the smoke config's own
    capacity factor: rank 0 alone prints the ``[train]`` lines of steps 0
    and 2, and they are the (2, 2) grid's ``train_loop`` run by the rank job
    (``CLI_LOOP``), to the printed digits (half a unit of the last, and
    TOL)."""
    args = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
            "--steps", str(CLI_LOOP["steps"]), "--batch", str(CLI_LOOP["batch"]),
            "--seq", str(CLI_LOOP["seq"]), "--data-ranks", "2", "--expert-ranks", "2"]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [tuple(float(x) for x in m.groups()) for m in _LINE.finditer(proc.stdout)]
    assert [s for s, *_ in lines] == [0.0, 2.0]
    for r in runs["cli"]:
        assert r["grid"] == [2, 2] and len(r["losses"]) == CLI_LOOP["steps"]
        for step, loss, gnorm in lines:
            want_l, want_g = r["losses"][int(step)], r["gnorms"][int(step)]
            assert abs(loss - want_l) <= 0.5e-4 + TOL * want_l
            assert abs(gnorm - want_g) <= 0.5e-2 + TOL * want_g


def test_checkpoints_cross_the_grid_and_one_process(runs):
    """At cf = E/K, f32, on the (2, 2) grid: a checkpoint the grid wrote at
    step 2 resumes in one process, one the one process wrote resumes on the
    grid, and each resumed third loss is the uninterrupted one's; the grid's
    file holds the whole banks in JAX's layout, and JAX's
    ``restore_checkpoint`` reads it as the port's does."""
    spec = runs["ckpt_spec"]
    cfg, loop, grid_dir = spec["cfg"], spec["loop"], spec["write_dir"]
    _, _, full = train.train_loop(cfg, steps=3, device="cpu", **loop)
    for r in runs["ckpt"]:
        assert max(abs(a - b) / b for a, b in zip(r["written"], full[:2])) <= TOL
        assert len(r["resumed"]) == 1 and abs(r["resumed"][0] - full[2]) <= TOL * full[2]
        assert r["step"] == 3
    _, opt, resumed = train.train_loop(cfg, steps=3, ckpt_dir=grid_dir, resume=True,
                                       ckpt_every=10**9, device="cpu", **loop)
    assert len(resumed) == 1 and abs(resumed[0] - full[2]) <= TOL * full[2]
    assert int(opt.step) == 3

    jax_params = jax.tree.map(jnp.asarray, numpy_params(cfg, 0))
    got, step, extra = jax_store.restore_checkpoint(
        grid_dir, (jax_params, jax_adamw_init(jax_params)), step=2)
    fresh = get_model(cfg).init(device="cpu")
    template = train.state_tree(fresh, adamw_init({k: p.detach()
                                                   for k, p in fresh.named_parameters()}))
    mine, _, _ = store.restore_checkpoint(grid_dir, template, step=2, device="cpu")
    assert step == 2 and extra == {"data": {"step": 2}}
    assert got[0]["blocks"]["moe"]["w1"].shape[1] == cfg.n_experts
    flat_jax, flat_port = ({**_flat(t[0]), **{f"m.{k}": v for k, v in _flat(t[1].m).items()},
                            **{f"v.{k}": v for k, v in _flat(t[1].v).items()}}
                           for t in (got, mine))
    assert set(flat_jax) == set(flat_port)
    assert all(np.array_equal(flat_jax[k], flat_port[k]) for k in flat_jax)
