"""The port on the card: the CUDA ``batched_degrees`` kernel against its
plain version, and the goldens through ``SolverSession(device="cuda")``.

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
from repro_torch.kernels.bitset_ops import batched_degrees, batched_degrees_ref

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
