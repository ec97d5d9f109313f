"""The port's package rules: no JAX, no ``repro``, the card unless asked.

* importing every ``repro_torch`` module loads no ``jax*`` module, no
  ``repro``/``repro.*`` module and no ``msgpack`` (the card's machine has
  none; the checkpoint manifests go through the port's own codec), checked
  in a fresh interpreter;
* no source file under ``src/repro_torch``, and not ``chip_smoke.py``,
  imports them (AST scan);
* ``SolverSession()`` with CUDA absent raises instead of running on the CPU;
* what the port does not carry yet refuses with its ROADMAP item, and fault
  injection, once refused, now runs.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
msgpack = sorted(m for m in sys.modules if m == "msgpack" or m.startswith("msgpack."))
print(json.dumps({"modules": names, "bad": bad, "msgpack": msgpack}))
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env=env, capture_output=True, text=True, check=True, timeout=120,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["msgpack"] == []
    # the probe really imported the slice's modules
    for name in (
        "repro_torch.api.session",
        "repro_torch.core.superstep",
        "repro_torch.kernels.bitset_ops.kernel",
        "repro_torch.launch.solve",
        "repro_torch.problems.vertex_cover",
        "repro_torch.problems.max_clique",
        "repro_torch.problems.mis",
        "repro_torch.api.cache",
        "repro_torch.configs.registry",
        "repro_torch.configs.qwen1_5_0_5b",
        "repro_torch.configs.rwkv6_3b",
        "repro_torch.kernels.flash_attention.kernel",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.kernels.wkv6.kernel",
        "repro_torch.kernels.wkv6.ops",
        "repro_torch.models.layers",
        "repro_torch.models.transformer",
        "repro_torch.models.rwkv6",
        "repro_torch.models.registry",
        "repro_torch.models.convert",
        "repro_torch.launch.serve_lm",
        "repro_torch.serving.balancer",
        "repro_torch.api.service",
        "repro_torch.launch.serve",
        "repro_torch.checkpoint.store",
        "repro_torch.checkpoint.solve",
        "repro_torch.checkpoint._msgpack",
        "repro_torch.core.encoding",
        "repro_torch.core.spill",
        "repro_torch.core.frontier",
        "repro_torch.faults",
        "repro_torch.faults.plan",
        "repro_torch.faults.injector",
    ):
        assert name in report["modules"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for name in ("core/encoding.py", "core/spill.py", "faults/__init__.py",
                 "faults/plan.py", "faults/injector.py"):
        assert PKG / name in files
    offenders = [
        (str(p.relative_to(ROOT)), root)
        for p in files
        for root in _imported_roots(p)
        if root in ("jax", "jaxlib", "repro", "msgpack")
    ]
    assert offenders == []


def test_session_without_cuda_raises(monkeypatch):
    from repro_torch.api import SolverSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverSession(device="cuda")
    assert SolverSession(device="cpu").device.type == "cpu"


def test_unported_features_refuse():
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(12, 0.3, 0)
    for kw in (
        dict(use_mesh=True),
        dict(explore_impl="reference"),
    ):
        session = SolverSession(config=SolveConfig(num_workers=2, **kw), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            session.solve(g)
    # fault injection is ported (item 11): a one-crash plan on the live
    # service is injected and recovered
    from repro_torch.api import SolveService
    from repro_torch.faults import FaultEvent, FaultInjector, FaultPlan

    inj = FaultInjector(FaultPlan(events=(FaultEvent("crash", at=1),)))
    svc = SolveService("max_clique", SolveConfig(num_workers=2, steps_per_round=2,
                                                 chunk_rounds=1), injector=inj,
                       device="cpu")
    t = svc.submit(erdos_renyi(16, 0.4, 0))
    svc.drain()
    assert svc.result(t).found
    assert inj.injected["crash"] == inj.recovered["crash"] == 1
    assert svc.stats()["lanes_quarantined"] == 1
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 12"):
        SolverSession(backend="protocol_sim", device="cpu")
