"""The cold tier rides checkpoints, across the packages.

``tests/test_spill.py``'s durability claims on ``device="cpu"``, in both
directions between the JAX package and the port: a spilled solve is cut at
a checkpoint whose cold tier holds records and resumed, or restored, in the
other package.  Each resume equals the uninterrupted run of both packages,
the spill counters included.

The shape is ``tests/test_spill.py``'s ``_SAT`` with 2 workers instead of
4: with 4, each pump refills the other workers below the low-water mark
from what it just spilled, so no chunk boundary of its solves ever holds a
cold record.  With 2 the tier holds records across chunks: the solo solve
is cut at ``max_rounds=8`` (7 records), ``solve_many`` of the four
instances of ``tests/test_spill.py`` resumes from steps that hold records
and runs on across its compaction, and the service is checkpointed after 4
steps (11 records).
"""

import os

import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.api import SolveService as JaxService
from repro.checkpoint.solve import SolveCheckpoint as JaxCheckpoint
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import SolveConfig, SolverSession, SolveService
from repro_torch.checkpoint.solve import SolveCheckpoint
from repro_torch.graphs.generators import erdos_renyi

from tests.test_torch_spill import _SAT, _fields

CPU = dict(device="cpu")
_DUR = {**_SAT, "num_workers": 2}
MANY = [(40, 0.28, s) for s in range(3)] + [(18, 0.35, 2)]
SERVICE = [(40, 0.28, s) for s in range(3)]


def _steps(d):
    return sorted(
        int(p[5:]) for p in os.listdir(d)
        if p.startswith("step_") and not p.endswith(".tmp")
    )


def _cold_records(arrays: dict) -> int:
    """Records in a checkpoint's cold tiers (every ``spill*.w*`` block)."""
    return sum(v.shape[0] for k, v in arrays.items()
               if k.rsplit("/", 1)[-1].startswith("spill") and ".w" in k)


def _writer(pkg):
    """(session class, config class, graph maker) of one package."""
    if pkg == "jax":
        return JaxSession, JaxConfig, jax_erdos_renyi, {}
    return SolverSession, SolveConfig, erdos_renyi, CPU


_BOTH = [("jax", "port"), ("port", "jax")]


@pytest.mark.parametrize("src,dst", _BOTH, ids=["jax_to_port", "port_to_jax"])
def test_solo_resume_mid_spill_across_packages(tmp_path, src, dst):
    cfg = dict(**_DUR, frontier_spill=True, checkpoint_every=1)
    full = _fields(SolverSession(config=SolveConfig(**cfg), **CPU).solve(
        erdos_renyi(40, 0.28, 0)))
    assert full == _fields(JaxSession(config=JaxConfig(**cfg)).solve(
        jax_erdos_renyi(40, 0.28, 0)))
    assert full["spilled_tasks"] > 0

    Session, Config, gen, kw = _writer(src)
    d = str(tmp_path / "ck")
    part = Session(config=Config(**cfg, max_rounds=8, checkpoint_dir=d), **kw).solve(
        gen(40, 0.28, 0))
    assert part.rounds == 8
    ck = SolveCheckpoint.load(d)
    assert ck.rounds == 8 and _cold_records(ck.arrays) > 0  # cut mid-spill

    # the cut's budget is not part of the trajectory: resume without it
    Session, _, _, kw = _writer(dst)
    res = Session.resume(d, checkpoint_dir=None, max_rounds=SolveConfig().max_rounds, **kw)
    assert res.stats.resumed_from
    assert _fields(res) == full


def _many_ck(tmp_path, pkg):
    Session, Config, gen, kw = _writer(pkg)
    d = str(tmp_path / pkg)
    cfg = Config(**_DUR, frontier_spill=True, compact_threshold=0.7, checkpoint_every=1)
    res = Session(config=cfg, **kw).solve_many([gen(*a) for a in MANY], checkpoint_dir=d)
    return d, res


@pytest.mark.parametrize("src,dst", _BOTH, ids=["jax_to_port", "port_to_jax"])
def test_solve_many_resume_mid_spill_across_packages(tmp_path, src, dst):
    d, run = _many_ck(tmp_path, src)
    other = _many_ck(tmp_path, dst)[1]
    want = [_fields(r) for r in run.results]
    assert [_fields(r) for r in other.results] == want
    assert run.compactions == 1
    # the step whose cold tiers hold the most records (the first bucket's
    # result is final there); the resume runs on across the compaction
    cold = {s: _cold_records(JaxCheckpoint.load(d, s).arrays) for s in _steps(d)}
    s = max(cold, key=cold.get)
    assert cold[s] > 0
    Session, _, _, kw = _writer(dst)
    rr = Session.resume(os.path.join(d, f"step_{s}"), checkpoint_dir=None, **kw)
    assert [_fields(r) for r in rr.results] == want
    assert rr.compactions == run.compactions
    assert rr.lane_stats.chunk_calls == run.lane_stats.chunk_calls


def _service(pkg):
    cfg = dict(**_DUR, frontier_spill=True, service_lanes=2)
    if pkg == "jax":
        return JaxService("vertex_cover", JaxConfig(**cfg)), jax_erdos_renyi
    return SolveService("vertex_cover", SolveConfig(**cfg), **CPU), erdos_renyi


def _restore(pkg, d):
    if pkg == "jax":
        return JaxService.restore(d)
    return SolveService.restore(d, **CPU)


@pytest.mark.parametrize("src,dst", _BOTH, ids=["jax_to_port", "port_to_jax"])
def test_service_restore_mid_spill_across_packages(tmp_path, src, dst):
    ref, gen = _service(dst)
    tickets = [ref.submit(gen(*a)) for a in SERVICE]
    ref.drain()
    want = {t: _fields(ref.result(t)) for t in tickets}
    assert sum(w["spilled_tasks"] for w in want.values()) > 0

    svc, gen = _service(src)
    assert [svc.submit(gen(*a)) for a in SERVICE] == tickets
    for _ in range(4):
        svc.step()
    d = str(tmp_path / "sck")
    svc.checkpoint(d)
    assert _cold_records(SolveCheckpoint.load(d).arrays) > 0  # cut mid-spill
    back = _restore(dst, d)
    assert back.tickets() == svc.tickets()
    back.drain()
    for t in tickets:
        assert _fields(back.result(t)) == want[t], t
