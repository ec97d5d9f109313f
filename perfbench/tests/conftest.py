"""Shared pieces of the harness's tests: the cells at a size the CPU runs
in a second or two, through the same code as on the card."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("vc-gnp600-lanes32", "mc-phat300-lanes64", "vc-gnp600-w2048")


def tiny(workload: str, n: int = None, root: Path = ROOT):
    """(config, traffic, end-to-end, per-layer) of ``workload`` with its
    graphs (``n`` vertices), lanes and engine cut to a CPU test's size."""
    from perfbench import bench

    _, config, traffic, e2e, per_layer = bench.load_cell(workload, root)
    config, traffic = copy.deepcopy(config), dict(traffic)
    config["graph"]["n"] = n or (40 if config["problem"] == "max_clique" else 60)
    config["engine"].update(num_workers=4, steps_per_round=4, chunk_rounds=2)
    traffic.update(pool=3, deadline_supersteps=40)
    traffic.update({k: v for k, v in (("lanes", 2), ("clients", 2), ("join_steps", 2),
                                      ("workers", 8), ("step_s", 0.04)) if k in traffic})
    return config, traffic, e2e, per_layer


def run_tiny(workload: str, seed: int = 2**31 + 5, trace: bool = False, n: int = None,
             root: Path = ROOT):
    import torch

    from perfbench import bench

    config, traffic, e2e, per_layer = tiny(workload, n, root)
    return bench.run_on(config, traffic, e2e, per_layer, chips=1, seed=seed, seconds=0.2,
                        trace=trace, t_start=time.perf_counter(),
                        device=torch.device("cpu"), root=root)


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
