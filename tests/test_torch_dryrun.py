"""The port's dry-run tools against the JAX package's, on the CPU.

``launch/analysis.py``, ``Model.batch_spec``, the LM kernels' meta route,
``launch/dryrun.py`` and ``bench/roofline_report.py``:

* ``model_flops`` equals JAX's ``repro.launch.analysis.model_flops`` for
  every arch x shape (that module sets no ``XLA_FLAGS``; JAX's
  ``launch/dryrun.py`` does, at import, so it is never imported here);
* a meta init holds exactly the parameters of JAX's abstract init
  (``jax.eval_shape``), and ``params_count`` is the same formula in both
  packages (an approximation of either count: it leaves out norms and
  biases);
* ``batch_spec`` gives JAX's shapes and dtypes for every arch x shape;
* the counted FLOPs of a smoke forward equal a hand count of its GEMMs and
  attention products (masked pairs included, as XLA counts them), and
  ``wkv6``'s formula FLOPs are what the meta route adds;
* ``argument_size_b`` equals the bytes of a real CPU init, AdamW state and
  batch at a smoke config;
* the CLI writes JAX's keys, keeps JAX's SKIP cells, and the report twin
  renders them.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import analysis as jax_analysis
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import ALIASES, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import meta
from repro_torch.kernels.wkv6.kernel import FLOPS_BACKWARD, FLOPS_FORWARD
from repro_torch.launch import analysis, dryrun
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import adamw_init

CELLS = [(a, s) for a in ALIASES for s in SHAPES]


def test_shapes_and_skip_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert len(dryrun.SKIP) == 8
    assert all(a in ALIASES and s in SHAPES for a, s in dryrun.SKIP)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    assert analysis.model_flops(get_config(arch), SHAPES[shape]) == \
        jax_analysis.model_flops(jax_get_config(arch), JAX_SHAPES[shape])


@pytest.mark.parametrize("arch", list(ALIASES))
def test_meta_init_holds_jax_parameters(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = get_model(cfg).init(device="meta")
    assert all(p.device.type == "meta" for p in params.parameters())
    n = sum(p.numel() for p in params.parameters())
    shapes = jax.eval_shape(lambda: jax_get_model(jcfg).init(jax.random.key(0))[0])
    assert n == sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert cfg.params_count() == jcfg.params_count()
    assert cfg.active_params_count() == jcfg.active_params_count()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_spec_equals_jax(arch, shape):
    spec = get_model(get_config(arch)).batch_spec(SHAPES[shape])
    want = jax_get_model(jax_get_config(arch)).batch_spec(JAX_SHAPES[shape])
    assert list(spec) == list(want)
    for k, t in spec.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


def _smoke(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), **kw)


def test_forward_flops_equal_a_hand_count():
    """qwen1.5's smoke prefill: the GEMMs (q, k, v, o, the SwiGLU's three,
    the unembedding) and attention's two products over every (query, key)
    pair, causal mask or not."""
    cfg = _smoke("qwen1_5_0_5b")
    Bt, S = 2, 24
    r = dryrun.run_cell(cfg, ShapeConfig("t", S, Bt, "prefill"))
    d, H, KV, Dh, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.d_ff, cfg.vocab)
    T = Bt * S
    layer = 2 * T * d * (H * Dh + 2 * KV * Dh) + 2 * T * H * Dh * d + 3 * 2 * T * d * f
    attention = 2 * (2 * Bt * H * S * S * Dh)
    want = cfg.n_layers * (layer + attention) + 2 * T * d * V
    assert r["cost"]["flops"] == want == r["cost"]["flops_aten"]
    assert r["cost"]["meta_routes"]["flash_attention"]["calls"] == cfg.n_layers
    assert r["cost"]["flops_formula"] == 0


def test_wkv6_formula_flops_are_added():
    cfg = _smoke("rwkv6_3b")
    Bt, S = 2, 16
    fwd = dryrun.run_cell(cfg, ShapeConfig("t", S, Bt, "prefill"))
    H, K = cfg.d_model // 64, 64
    per_call = Bt * S * H * K * K
    routes = fwd["cost"]["meta_routes"]
    assert routes["wkv6"]["calls"] == cfg.n_layers
    assert fwd["cost"]["flops_formula"] == routes["wkv6"]["flops"] == \
        FLOPS_FORWARD * per_call * cfg.n_layers
    assert fwd["cost"]["flops"] == fwd["cost"]["flops_aten"] + fwd["cost"]["flops_formula"]
    train = dryrun.run_cell(cfg, ShapeConfig("t", S, Bt, "train"))
    routes = train["cost"]["meta_routes"]
    # the forward, its remat recompute, and the backward by formula
    assert routes["wkv6"]["calls"] == 2 * cfg.n_layers
    assert routes["wkv6.backward"]["flops"] == FLOPS_BACKWARD * per_call * cfg.n_layers


def test_meta_routes_launch_nothing():
    from repro_torch.kernels import counts

    counts.reset()
    dryrun.run_cell(_smoke("rwkv6_3b"), ShapeConfig("t", 8, 1, "train"))
    dryrun.run_cell(_smoke("qwen1_5_0_5b"), ShapeConfig("t", 8, 1, "train"))
    assert counts.snapshot() == {}
    assert not meta.inside()


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "whisper_large_v3", "pixtral_12b"])
def test_argument_bytes_equal_a_real_cpu_init(arch):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("t", 12, 2, "train")
    r = dryrun.run_cell(cfg, shape)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(dict(params.named_parameters()))
    batch = model.batch_spec(shape, device="cpu")
    tensors = [*params.parameters(), opt.step, *opt.m.values(), *opt.v.values(),
               *batch.values()]
    assert r["memory"]["argument_size_b"] == meta.nbytes(*tensors)
    assert r["memory"]["peak_estimate_b"] > r["memory"]["argument_size_b"]


def test_decode_cell_counts_the_cache_as_arguments():
    cfg = get_smoke_config("qwen1_5_0_5b")
    shape = ShapeConfig("t", 64, 2, "decode")
    r = dryrun.run_cell(cfg, shape)
    model = get_model(cfg)
    params = model.init(device="cpu")
    cache = model.init_decode_cache(2, 64, device="cpu")
    want = meta.nbytes(*params.parameters(), cache["k"], cache["v"]) + 2 * 4
    assert r["memory"]["argument_size_b"] == want


def test_cli_writes_jax_keys_and_skips(tmp_path):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(out)])
    assert rc == 0
    rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--out", str(out)])
    assert rc == 0
    results = {r["shape"]: r for r in json.loads(out.read_text())}
    assert results["long_500k"] == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                                    "status": "SKIP", "reason": "full attention"}
    ok = results["decode_32k"]
    assert ok["status"] == "OK"
    assert {"memory", "cost", "roofline", "collectives", "collective_counts"} <= set(ok)
    rl = ok["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "bound_s",
                "compute_fraction", "model_flops_global", "model_flops_per_dev",
                "useful_flop_ratio"):
        assert key in rl
    assert rl["memory_s"] == ok["cost"]["bytes_accessed"] / analysis.HBM_BW
    assert rl["compute_s"] == ok["cost"]["flops"] / analysis.PEAK_FLOPS
    assert ok["memory"]["fits"] == (ok["memory"]["peak_estimate_b"] <= ok["memory"]["card_bytes"])

    from repro_torch.bench import roofline_report

    table = tmp_path / "table.md"
    roofline_report.main([str(out), "--md", "--out", str(table)])
    lines = table.read_text().splitlines()
    assert lines[0].split("|")[7].strip() == "mfu%" and len(lines) == 4
    mfu = 100 * rl["model_flops_per_dev"] / analysis.PEAK_FLOPS / rl["bound_s"]
    assert f"{mfu:.1f}" in lines[2] or f"{mfu:.1f}" in lines[3]


def test_expert_parallel_cell_sizes_one_rank():
    """``--moe-impl shard_map``: one rank's E/M experts, and the three
    all-reduces a layer the route issues (counted by the stand-in); its
    train cell is counted too (``test_expert_parallel_train_cell_counts_
    the_backward``)."""
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    shape = ShapeConfig("t", 8, 2, "prefill")
    whole = dryrun.run_cell(cfg, shape)
    ep = dryrun.run_cell(cfg, shape, expert_ranks=4)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    bank = cfg.n_layers * 3 * E * d * f * 4
    assert whole["memory"]["argument_size_b"] - ep["memory"]["argument_size_b"] == bank * 3 // 4
    assert ep["collective_counts"]["all-reduce"] == 3 * cfg.n_layers
    assert ep["collectives"]["all-reduce"] == cfg.n_layers * 2 * 4 * (2 * E + 16 * d)
    train = dryrun.run_cell(cfg, ShapeConfig("t", 8, 2, "train"), expert_ranks=4)
    assert train["status"] == "OK" and train["mesh"] == "1 rank of 4 (expert parallel)"


def test_expert_parallel_train_cell_counts_the_backward():
    """The train cell under ``--moe-impl shard_map --expert-ranks 4`` counts
    the expert-parallel step, by hand: a layer's forward (the counts' and
    the mean probabilities' reductions over the data ranks, E f32 each, and
    the output's SUM over the model ranks, (Tg, d) f32), the remat
    recompute's rerun of the two data reductions (torch's recompute stops at
    the last tensor the backward needs, before the SUM, which no backward
    reads), and the backward's sums over the model ranks of x's cotangent,
    (Tg, d), and the router's, (d, E); then one sum of the expert shards'
    squares, a vector of the tree's leaves.  On one data rank nothing is
    averaged.  All-reduces counted ×2."""
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    shape = ShapeConfig("t", 8, 2, "train")
    r = dryrun.run_cell(cfg, shape, expert_ranks=4)
    E, d, L = cfg.n_experts, cfg.d_model, cfg.n_layers
    Tg = shape.global_batch * shape.seq_len
    leaves = 3 + L * 10  # embed, ln_f, unembed; ln1, ln2, 4 attention, router, w1, w3, w2
    forward = 4 * (E + E + Tg * d)
    recompute = 4 * (E + E)
    backward = 4 * (Tg * d + d * E)
    assert r["collective_counts"]["all-reduce"] == L * (3 + 2 + 2) + 1
    assert r["collectives"]["all-reduce"] == 2 * (L * (forward + recompute + backward)
                                                  + 4 * leaves)
    assert r["collectives"]["total"] == r["collectives"]["all-reduce"]
    prefill = dryrun.run_cell(cfg, ShapeConfig("t", 8, 2, "prefill"), expert_ranks=4)
    assert r["cost"]["flops"] > 3 * prefill["cost"]["flops"] > 0


def test_expert_ranks_leave_an_arch_without_experts_one_card():
    """JAX's ``--moe-impl shard_map`` is a rule override that an arch
    without experts ignores: the port runs that arch's one-card cell."""
    cfg = get_smoke_config("qwen1_5_0_5b")
    shape = ShapeConfig("t", 8, 2, "prefill")
    drop = lambda r: {k: v for k, v in r.items() if k != "trace_s"}  # noqa: E731
    assert drop(dryrun.run_cell(cfg, shape, expert_ranks=4)) == drop(dryrun.run_cell(cfg, shape))


def test_all_cells_under_shard_map_end_with_no_error(monkeypatch, tmp_path, capsys):
    """``--all --moe-impl shard_map`` completes as JAX's CLI does: every
    cell OK or SKIP.  The step is stubbed (the cells' counts are the other
    tests'); what is held is which cells run expert-parallel."""
    ran = []

    def build_cell(model, shape, *, expert_ranks=0):
        ran.append((model.cfg.name, shape.name, expert_ranks))
        return (lambda: None), [], None

    monkeypatch.setattr(dryrun, "build_cell", build_cell)
    monkeypatch.setattr(dryrun, "count_step", lambda step, args: {
        "flops": 1.0, "flops_aten": 1.0, "flops_formula": 0.0, "bytes_accessed": 1.0,
        "activation_peak_b": 0, "meta_routes": {}})
    out = tmp_path / "dry.json"
    assert dryrun.main(["--all", "--moe-impl", "shard_map", "--out", str(out)]) == 0
    assert "0 ERROR" in capsys.readouterr().out
    results = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    assert len(results) == len(CELLS)
    skipped = {k for k, r in results.items() if r["status"] == "SKIP"}
    moe_train = {(get_config(a).name, s) for a, s in CELLS
                 if get_config(a).is_moe and SHAPES[s].kind == "train"}
    assert skipped == set(dryrun.SKIP)
    assert moe_train and all(results[k]["status"] == "OK" for k in moe_train)
    assert {(n, s) for n, s, e in ran if e == 4} >= moe_train
    for name, shape, expert_ranks in ran:
        assert expert_ranks == (4 if get_config(name).is_moe else 0), (name, shape)
    assert {e for *_, e in ran} == {0, 4}


def test_collective_bytes_convention():
    out = analysis.collective_bytes({"all-gather": 16, "all-reduce": 4}, {"all-gather": 1,
                                                                         "all-reduce": 1})
    assert out["all-gather"] == 16 and out["all-reduce"] == 8 and out["total"] == 24
    assert set(out) == {*analysis.COLLECTIVES, "total", "counts"}
    assert set(out["counts"]) == set(jax_analysis._COLLECTIVES) == set(analysis.COLLECTIVES)
    rl = analysis.roofline(989e12, 3.35e12, 0.0)
    assert rl["compute_s"] == pytest.approx(1.0) and rl["memory_s"] == pytest.approx(1.0)
    assert set(rl) == set(jax_analysis.roofline(1.0, 1.0, 1.0))
