"""The port on the card: the CUDA ``batched_degrees`` and
``batched_expand_stats`` kernels against their plain versions (one instance
and a padded batch with a task-row map), and the goldens through
``SolverSession(device="cuda")``.

These tests need an NVIDIA GPU and skip elsewhere.  On a machine with one:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.bitgraph import mask_full, n_words
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.kernels import counts
from repro_torch.kernels.bitset_ops import (
    batched_degrees,
    batched_degrees_ref,
    batched_expand_stats,
    expand_stats_ref,
)

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
