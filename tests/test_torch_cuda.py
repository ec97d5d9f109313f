"""The port on the card: the CUDA ``batched_degrees`` and
``batched_expand_stats`` kernels against their plain versions (one instance
and a padded batch with a task-row map), the goldens through
``SolverSession(device="cuda")``, the CUDA ``flash_attention`` and ``wkv6``
kernels against their plain versions, and the LM serving path through them.

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
    expand_stats_ref,
)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, flash_attention_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.launch.serve_lm import greedy_decode
from repro_torch.models.convert import load_jax_params, numpy_params
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
    r = SolverSession(config=SolveConfig(**case["solve_kw"]), device=cuda).solve(g)
    assert counts.snapshot()["batched_degrees"] > 0
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
    assert counts.snapshot() == {"batched_expand_stats": ran * cfg.steps_per_round}


# JAX's attention CASES (tests/test_kernels_attention.py:22-30), plus head
# sizes that are not powers of two, D = 128 and GQA at the serving widths
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
    assert counts.snapshot() == {"flash_attention": 1}
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


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head size"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q[..., :8].half(), q[..., :8].half(), q[..., :8].half())
    r = torch.zeros(1, 4, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r.double(), r.double(), r.double(), r.double(), r[0, 0].double())
    with pytest.raises(ValueError, match="K, V <= 64"):
        big = torch.zeros(1, 4, 2, 80, device=cuda)
        wkv6(big, big, big, big, big[0, 0])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "starcoder2_3b", "rwkv6_3b"])
def test_lm_smoke_on_card_equals_cpu(cuda, arch):
    """The smoke configs in f32: the card's forward (one kernel launch per
    layer) and greedy tokens equal the CPU's plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    tree = numpy_params(cfg, 0)
    on_cpu = load_jax_params(model.init(device="cpu"), tree)
    on_card = load_jax_params(model.init(device=cuda), tree)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)))
    counts.reset()
    got = model.forward(on_card, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    kernel = "wkv6" if cfg.family == "ssm" else "flash_attention"
    assert counts.snapshot() == {kernel: cfg.n_layers}
    want = model.forward(on_cpu, {"tokens": toks})
    assert (got.cpu() - want).abs().max() < 1e-4
    gen_card, _ = greedy_decode(model, on_card, toks[:, :8].to(cuda), 6)
    gen_cpu, _ = greedy_decode(model, on_cpu, toks[:, :8], 6)
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
