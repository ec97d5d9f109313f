"""The port on the card: the CUDA ``batched_degrees``,
``batched_expand_stats``, ``vc_expand`` and ``clique_expand`` kernels
against their plain versions (one instance and a padded batch with a
task-row map), the goldens through ``SolverSession(device="cuda")`` (one
fused launch per explore round), the CUDA ``flash_attention`` (both
variants: tensor cores and CUDA cores) and ``wkv6`` kernels against their
plain versions, and the LM serving path through them.

These tests need an NVIDIA GPU and skip elsewhere.  On a machine with one:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.configs import get_smoke_config
from repro_torch.graphs.bitgraph import mask_full, n_words
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.kernels import counts
from repro_torch.kernels.bitset_ops import (
    batched_degrees,
    batched_degrees_ref,
    batched_expand_stats,
    clique_expand,
    clique_expand_ref,
    expand_stats_ref,
    vc_expand,
    vc_expand_ref,
)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.kernel import variant_for
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.launch.serve_lm import greedy_decode
from repro_torch.models.convert import frames, load_jax_params, numpy_params
from repro_torch.models.registry import get_model

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is false")
    return torch.device("cuda")


def _on(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("n", [1, 31, 33, 600, 2048])
@pytest.mark.parametrize("T", [1, 7, 128])
def test_kernel_equals_plain_version(cuda, n, T):
    g = erdos_renyi(n, min(1.0, 8.0 / max(n - 1, 1)), n + T)
    rng = np.random.default_rng(T)
    masks = rng.integers(0, 2**32, size=(T, n_words(n)), dtype=np.uint32)
    masks &= mask_full(n)
    masks[0] = mask_full(n)
    adj, m = _on(g.adj, cuda), _on(masks, cuda)
    counts.reset()
    got = batched_degrees(adj, m)
    torch.cuda.synchronize()
    assert counts.snapshot() == {"batched_degrees": 1}
    assert torch.equal(got, batched_degrees_ref(adj, m))


def test_goldens_on_card(cuda):
    golden = json.loads((ROOT / "tests" / "golden_vc.json").read_text())
    case = golden["solo"]["multi_lane_donate"]
    g = erdos_renyi(**case["graph"])
    counts.reset()
    cfg = SolveConfig(**case["solve_kw"])
    r = SolverSession(config=cfg, device=cuda).solve(g)
    # one fused launch per explore round, no panel kernel
    assert counts.snapshot() == {"vc_expand": r.rounds * cfg.steps_per_round}
    want = case["result"]
    assert r.best_size == want["best_size"]
    assert [int(w) for w in np.asarray(r.best_sol, np.uint32)] == want["best_sol"]
    assert (r.rounds, r.nodes_expanded) == (want["rounds"], want["nodes_expanded"])


@pytest.mark.parametrize("n", [1, 33, 300, 600])
@pytest.mark.parametrize("T", [1, 7, 128])
@pytest.mark.parametrize("B", [1, 3])
def test_expand_stats_kernel_equals_plain_version(cuda, n, T, B):
    rng = np.random.default_rng(n + T + B)
    W = n_words(n)
    adj = np.stack([erdos_renyi(n, min(1.0, 8.0 / max(n - 1, 1)), n + b).adj for b in range(B)])
    masks = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n)
    sols = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n)
    masks[0], sols[0] = mask_full(n), 0
    inst = None if B == 1 else torch.from_numpy(rng.integers(0, B, size=T).astype(np.int32)).to(cuda)
    a, m, s = _on(adj, cuda), _on(masks, cuda), _on(sols, cuda)
    counts.reset()
    deg, pc = batched_expand_stats(a, m, s, inst)
    got_deg = batched_degrees(a, m, inst)
    torch.cuda.synchronize()
    assert counts.snapshot() == {"batched_expand_stats": 1, "batched_degrees": 1}
    rdeg, rpm, rps = expand_stats_ref(a, m, s, inst)
    assert torch.equal(deg, rdeg) and torch.equal(got_deg, rdeg)
    assert torch.equal(pc, torch.stack([rpm, rps], 1))


def test_max_clique_batch_on_card(cuda):
    """clique_smoke's configuration: one expand_stats launch per explore
    round for the whole batch, and the sizes [4, 6, 4, 4]."""
    graphs = [erdos_renyi(20, 0.4, seed) for seed in range(4)]
    cfg = SolveConfig(num_workers=4, steps_per_round=8)
    counts.reset()
    batch = SolverSession(problem="max_clique", config=cfg, device=cuda).solve_many(graphs)
    assert [r.best_size for r in batch.results] == [4, 6, 4, 4]
    ran = max(r.rounds for r in batch.results)
    assert counts.snapshot() == {"clique_expand": ran * cfg.steps_per_round}


def _expand_rows(n, T, B, seed):
    """adj (B, n, W) of B random graphs (instance b > 0 smaller, zero
    padding rows), a row map, and (T, W) masks and sols of each row's own
    instance: random rows, then an empty, a full and a single-bit mask."""
    rng = np.random.default_rng(seed)
    W = n_words(n)
    sizes = [n] + [max(1, n - 1 - b * (n // 3)) for b in range(1, B)]
    adj = np.zeros((B, n, W), np.uint32)
    for b, nb in enumerate(sizes):
        adj[b, :nb, : n_words(nb)] = erdos_renyi(nb, min(1.0, 8.0 / max(nb - 1, 1)), seed + b).adj
    inst = rng.integers(0, B, size=T).astype(np.int32)
    own = np.zeros((T, W), np.uint32)
    for t in range(T):
        f = mask_full(sizes[inst[t]])
        own[t, : f.shape[0]] = f
    masks = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & own
    sols = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & own & ~masks
    if T >= 4:
        masks[1], masks[2], masks[3] = 0, own[2], 0
        v = min(31, sizes[inst[3]] - 1)
        masks[3, v // 32] = np.uint32(1) << np.uint32(v % 32)
        sols[2] = 0
    return adj, (inst if B > 1 else None), masks, sols


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 2, 7, 128, 1024])
@pytest.mark.parametrize("n", [1, 31, 33, 300, 600, 1300, 2048])
@pytest.mark.parametrize("kernel,plain", [(vc_expand, vc_expand_ref),
                                          (clique_expand, clique_expand_ref)],
                         ids=["vc_expand", "clique_expand"])
def test_expand_kernel_equals_plain_version(cuda, kernel, plain, n, T, B):
    """Every output exactly (vertex cover's trip counts too): the adjacency
    staged in shared memory up to n = 1300, read from L2 at 2048."""
    adj, inst, masks, sols = _expand_rows(n, T, B, n + T + B)
    a, m, s = _on(adj, cuda), _on(masks, cuda), _on(sols, cuda)
    i = None if inst is None else torch.from_numpy(inst).to(cuda)
    counts.reset()
    got = kernel(a, m, s, i)
    torch.cuda.synchronize()
    assert counts.snapshot() == {kernel.__name__: 1}
    want = plain(a, m, s, i)
    for field, x in got._asdict().items():
        y = getattr(want, field)
        assert (x is None and y is None) or torch.equal(x, y), field


@pytest.mark.parametrize("problem", ["vertex_cover", "max_clique"])
def test_composed_expansion_runs_the_panel_kernels(cuda, problem):
    """With ``expand_tasks=None`` the plane composes the problem's
    callables, whose panels are the batched_degrees / batched_expand_stats
    kernels; the trajectory is the fused one's."""
    import dataclasses

    from repro_torch.problems.registry import get_problem

    spec = get_problem(problem)
    composed = dataclasses.replace(spec, expand_tasks=None)
    g = erdos_renyi(30, 0.22 if problem == "vertex_cover" else 0.4, 0)
    cfg = SolveConfig(num_workers=5, steps_per_round=8)
    counts.reset()
    r = SolverSession(composed, config=cfg, device=cuda).solve(g)
    launches = counts.snapshot()
    fused = SolverSession(spec, config=cfg, device=cuda).solve(g)
    assert (r.best_size, r.rounds, r.nodes_expanded, r.stats.reduce_sweeps) == (
        fused.best_size, fused.rounds, fused.nodes_expanded, fused.stats.reduce_sweeps)
    panel = "batched_degrees" if problem == "vertex_cover" else "batched_expand_stats"
    assert launches.get(panel, 0) > 0 and set(launches) <= {"batched_degrees", panel}


# JAX's attention CASES (tests/test_kernels_attention.py:22-30), plus head
# sizes that are not powers of two, D = 128 and GQA at the serving widths,
# and D = 256 (recurrentgemma's local attention: MQA under a window)
ATTN_CASES = [
    dict(B=2, Sq=64, Sk=64, Hq=4, Hkv=2, D=32, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, Hq=4, Hkv=1, D=64, causal=True, window=32),
    dict(B=2, Sq=1, Sk=96, Hq=8, Hkv=4, D=32, causal=True, window=None),
    dict(B=1, Sq=50, Sk=50, Hq=2, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=1, D=32, causal=True, window=None),
    dict(B=1, Sq=1, Sk=77, Hq=4, Hkv=2, D=64, causal=True, window=24),
    dict(B=3, Sq=33, Sk=33, Hq=6, Hkv=3, D=8, causal=True, window=16),
    dict(B=2, Sq=40, Sk=40, Hq=4, Hkv=2, D=12, causal=True, window=None),
    dict(B=1, Sq=200, Sk=200, Hq=24, Hkv=2, D=128, causal=True, window=None),
    dict(B=2, Sq=1, Sk=1057, Hq=16, Hkv=16, D=64, causal=True, window=None),
    dict(B=2, Sq=100, Sk=100, Hq=4, Hkv=1, D=256, causal=True, window=40),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=2, D=256, causal=False, window=None),
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_equals_plain_version(cuda, case, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    g = torch.Generator(device="cpu").manual_seed(case["Sk"] + case["D"])
    c = case
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype) for s in (
        (c["B"], c["Sq"], c["Hq"], c["D"]), (c["B"], c["Sk"], c["Hkv"], c["D"]),
        (c["B"], c["Sk"], c["Hkv"], c["D"])))
    kw = dict(causal=c["causal"], window=c["window"])
    counts.reset()
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert counts.snapshot() == {f"flash_attention.{variant_for(q, k, v)}": 1}
    assert got.dtype == dtype and got.shape == q.shape
    plain = flash_attention_plain(q, k, v, **kw)
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert (got.float() - plain.float()).abs().max() < tol
    assert (got.float() - ref).abs().max() < tol


@pytest.mark.parametrize("B,T,H,K,V", [
    (2, 64, 2, 16, 16), (1, 128, 4, 32, 32), (2, 96, 1, 8, 24), (1, 32, 2, 64, 64),
    (1, 64, 3, 16, 48), (2, 50, 2, 16, 16), (1, 1, 40, 64, 64), (2, 300, 4, 64, 64),
])
@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_kernel_equals_plain_version(cuda, B, T, H, K, V, with_state):
    g = torch.Generator(device="cpu").manual_seed(B * T + K)
    f = lambda *s: (torch.randn(s, generator=g) * 0.5).to(cuda)
    r, k, v = f(B, T, H, K), f(B, T, H, K), f(B, T, H, V)
    decay = torch.exp(-torch.exp(-torch.empty(B, T, H, K).uniform_(0.2, 3.0, generator=g))).to(cuda)
    u = f(H, K) * 0.6
    s0 = f(B, H, K, V) * 0.4 if with_state else None
    counts.reset()
    o, s = wkv6(r, k, v, decay, u, s0)
    torch.cuda.synchronize()
    assert counts.snapshot() == {"wkv6": 1}
    o_ref, s_ref = wkv6_ref(r, k, v, decay, u, s0)
    assert (o - o_ref).abs().max() < 3e-4
    assert (s - s_ref).abs().max() < 3e-4


# the tensor-core variant's shapes: the serving shapes of chip_smoke.py
# (qwen1.5-0.5b's prefill, starcoder2-3b's GQA widths, a window, one query
# against 1,057 keys) and ragged query counts, D 64, 128 and 256 (four
# panels, 32-key tiles)
TC_CASES = [
    dict(B=4, Sq=1024, Sk=1024, Hq=16, Hkv=16, D=64, causal=True, window=None),
    dict(B=4, Sq=1024, Sk=1024, Hq=24, Hkv=2, D=128, causal=True, window=None),
    dict(B=4, Sq=1024, Sk=1024, Hq=16, Hkv=16, D=64, causal=True, window=256),
    dict(B=4, Sq=1, Sk=1057, Hq=16, Hkv=16, D=64, causal=True, window=None),
] + [
    dict(B=2, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv, D=d, causal=True, window=w)
    for sq, sk in ((1, 1), (33, 33), (70, 70), (33, 130))
    for hq, hkv, d, w in ((4, 1, 64, None), (6, 2, 128, 24), (4, 1, 256, 16))
]


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_attention_within_one_bf16_step(cuda, case):
    """Every output element within one bf16 step of the plain version (both
    round once to bf16 from f32), as chip_smoke.py's serving check."""
    c = case
    g = torch.Generator(device="cpu").manual_seed(c["Sq"] * 7 + c["D"])
    q, k, v = (torch.randn(s, generator=g).to(cuda, torch.bfloat16) for s in (
        (c["B"], c["Sq"], c["Hq"], c["D"]), (c["B"], c["Sk"], c["Hkv"], c["D"]),
        (c["B"], c["Sk"], c["Hkv"], c["D"])))
    kw = dict(causal=c["causal"], window=c["window"])
    assert variant_for(q, k, v) == "tensor_core"
    counts.reset()
    got = flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert counts.snapshot() == {"flash_attention.tensor_core": 1}
    want = flash_attention_plain(q, k, v, **kw).float()
    step = 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6
    assert bool(((got - want).abs() <= step).all())
    # the CUDA-core variant on the same inputs, asked for by name
    other = flash_attention(q, k, v, **kw, variant="cuda_core").float()
    assert counts.snapshot() == {"flash_attention.tensor_core": 1, "flash_attention.cuda_core": 1}
    assert (other - want).abs().max() < 2e-2


def test_tensor_core_attention_reads_strided_views(cuda):
    """A (B, H, S, D) tensor viewed as (B, S, H, D): the 4-D tensor map takes
    its strides as they are."""
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(2, h, 70, 64, generator=g).to(cuda, torch.bfloat16).transpose(1, 2)
               for h in (4, 2, 2))
    assert variant_for(q, k, v) == "tensor_core" and not q.is_contiguous()
    got = flash_attention(q, k, v).float()
    want = flash_attention_plain(q, k, v).float()
    step = 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6
    assert bool(((got - want).abs() <= step).all())


@pytest.mark.parametrize("V", [24, 48, 64])
@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("T", [1, 50, 1024])
@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_value_tiles_and_k_slices(cuda, V, K, T, with_state):
    """The split kernel at value widths that are not a multiple of its
    16-column tiles, K below its 16 slices of 4, and T ragged, 1 and long."""
    B, H = 2, 3
    g = torch.Generator(device="cpu").manual_seed(V * 1000 + K * 10 + T)
    f = lambda *s: (torch.randn(s, generator=g) * 0.5).to(cuda)
    r, k, v = f(B, T, H, K), f(B, T, H, K), f(B, T, H, V)
    decay = torch.exp(-torch.exp(-torch.empty(B, T, H, K).uniform_(0.2, 3.0, generator=g))).to(cuda)
    u = f(H, K) * 0.6
    s0 = f(B, H, K, V) * 0.4 if with_state else None
    counts.reset()
    o, s = wkv6(r, k, v, decay, u, s0)
    torch.cuda.synchronize()
    assert counts.snapshot() == {"wkv6": 1}
    o_ref, s_ref = wkv6_ref(r, k, v, decay, u, s0)
    assert (o - o_ref).abs().max() < 3e-4
    assert (s - s_ref).abs().max() < 3e-4


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 272, device=cuda)  # D above 256
    with pytest.raises(ValueError, match="head size"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q[..., :8].half(), q[..., :8].half(), q[..., :8].half())
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        flash_attention(q[..., :64], q[..., :64], q[..., :64], variant="tensor_core")  # f32
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        b8 = q[..., :8].to(torch.bfloat16)
        flash_attention(b8, b8, b8, variant="tensor_core")  # D = 8
    r = torch.zeros(1, 4, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r.double(), r.double(), r.double(), r.double(), r[0, 0].double())
    with pytest.raises(ValueError, match="K, V <= 64"):
        big = torch.zeros(1, 4, 2, 80, device=cuda)
        wkv6(big, big, big, big, big[0, 0])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "starcoder2_3b", "rwkv6_3b",
                                  "recurrentgemma_9b", "whisper_large_v3"])
def test_lm_smoke_on_card_equals_cpu(cuda, arch):
    """The smoke configs in f32: the card's forward (one kernel launch per
    attention or time-mix layer, an encoder's too) and greedy tokens (past
    Griffin's 16-slot ring; whisper's decode primed with the frames) equal
    the CPU's plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    tree = numpy_params(cfg, 0)
    on_cpu = load_jax_params(model.init(device="cpu"), tree)
    on_card = load_jax_params(model.init(device=cuda), tree)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)))
    fr = torch.from_numpy(frames(cfg, 2, 2)) if cfg.family == "encdec" else None
    on = lambda dev: {"tokens": toks.to(dev), **({} if fr is None else {"frames": fr.to(dev)})}
    counts.reset()
    got = model.forward(on_card, on(cuda))
    torch.cuda.synchronize()
    # f32: attention runs on the CUDA-core variant
    kernel = "wkv6" if cfg.family == "ssm" else "flash_attention.cuda_core"
    n = {"hybrid": cfg.layer_kinds().count("attn"),
         "encdec": cfg.n_enc_layers + cfg.n_layers}.get(cfg.family, cfg.n_layers)
    assert counts.snapshot() == {kernel: n}
    want = model.forward(on_cpu, on("cpu"))
    assert (got.cpu() - want).abs().max() < 1e-4
    gen = 12 if cfg.family == "hybrid" else 6  # 8 + 12 tokens wrap the 16-slot ring
    gen_card, _ = greedy_decode(model, on_card, toks[:, :8].to(cuda), gen,
                                frames=None if fr is None else fr.to(cuda))
    gen_cpu, _ = greedy_decode(model, on_cpu, toks[:, :8], gen, frames=fr)
    assert torch.equal(gen_card.cpu(), gen_cpu)


def test_rwkv6_multi_token_decode_on_card(cuda):
    """decode_fn given several tokens launches the kernel from the cached
    state, one launch per layer, and equals one decode_fn over them all."""
    cfg = get_smoke_config("rwkv6_3b")
    model = get_model(cfg)
    params = load_jax_params(model.init(device=cuda), numpy_params(cfg, 3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))).to(cuda)
    counts.reset()
    one, c1 = model.decode_fn(params, model.init_decode_cache(2, 0, device=cuda), toks)
    h1, c2 = model.decode_fn(params, model.init_decode_cache(2, 0, device=cuda), toks[:, :7])
    h2, c2 = model.decode_fn(params, c2, toks[:, 7:])
    torch.cuda.synchronize()
    assert counts.snapshot() == {"wkv6": 3 * cfg.n_layers}
    assert (torch.cat([h1, h2], 1) - one).abs().max() < 1e-4
    assert (c1["wkv"] - c2["wkv"]).abs().max() < 1e-4
