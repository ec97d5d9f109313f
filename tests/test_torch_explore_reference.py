"""The port's reference explore path, ``explore_impl="reference"``, on the CPU.

The reference route pops with the full-capacity sort ``pop_deepest`` and
always expands through the composed callables (``task_bound``,
``branch_once``, ``child_bound``); the fused route pops with
``pop_deepest_cheap`` and expands with the plugin's ``expand_tasks``.  As in
``tests/test_explore_fused.py``, the knob switches implementations, never the
search:

* every vertex-cover golden of ``tests/golden_vc.json`` (solo, fpt and
  ``solve_many`` with its padding and compaction), which the JAX package's
  reference path reproduces (its ``test_explore_fused.py``), comes out of the
  port's reference path bit for bit, and equal to the port's fused path;
* max clique and MIS, solo, FPT and ``solve_many``: the port's reference
  path equals the JAX package's reference path and the port's fused path;
* ``pop_deepest`` and ``pop_deepest_cheap`` pop the same valid tasks and
  leave the same active set on random depth tables.

``reduce_sweeps`` (the port's own counter) is the largest trip count over
every popped row of a round, valid or not.  With more than one lane a worker
with fewer active tasks than lanes pops invalid rows, and the two pops hand
different stale slots to them (the sort its lowest inactive slots, the cheap
pop slot 0 again), so the counts may differ there and only there: with the
invalid rows' masks emptied the two routes count the same sweeps.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.core import frontier as jf
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import SolveConfig, SolverSession
from repro_torch.api.backends import config_from_legacy
from repro_torch.core import frontier as tf
from repro_torch.core import superstep
from repro_torch.graphs.generators import erdos_renyi

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_vc.json").read_text())
CPU = dict(device="cpu")
IMPLS = ("fused", "reference")


def _record(r) -> dict:
    """The golden's fields (the JAX package's)."""
    return {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
    }


def _full(r) -> dict:
    rec = _record(r) if r.best_sol is not None else {"best_size": int(r.best_size)}
    return {**rec, "rounds": int(r.rounds), "nodes_expanded": int(r.nodes_expanded),
            "overflow_count": int(r.stats.overflow_count)}


def _sessions(legacy_kw: dict, **extra) -> dict:
    cfg = config_from_legacy(**legacy_kw, **extra)
    return {impl: SolverSession(config=cfg.replace(explore_impl=impl), **CPU)
            for impl in IMPLS}


def _same_sweeps_unless_lanes(a, b, lanes: int) -> None:
    """``reduce_sweeps`` agrees on one lane; with more, invalid rows may
    differ (the module docstring; ``test_sweeps_differ_only_by_invalid_rows``)."""
    if lanes == 1:
        assert a.stats.reduce_sweeps == b.stats.reduce_sweeps


@pytest.mark.parametrize("label", sorted(GOLDEN["solo"]))
def test_solo_golden_reference_equals_golden_and_fused(label):
    case = GOLDEN["solo"][label]
    g = erdos_renyi(**case["graph"])
    out = {impl: s.solve(g) for impl, s in _sessions(case["solve_kw"]).items()}
    assert _record(out["reference"]) == case["result"]
    assert _record(out["fused"]) == case["result"]
    _same_sweeps_unless_lanes(out["reference"], out["fused"],
                              case["solve_kw"].get("lanes", 1))


def test_fpt_golden_reference_equals_golden_and_fused():
    case = GOLDEN["fpt"]
    g = erdos_renyi(**case["graph"])
    out = {impl: s.solve(g) for impl, s in
           _sessions({"num_workers": 4}, mode="fpt", k=case["k"]).items()}
    for r in out.values():
        assert _record(r) == case["result"]
    assert out["reference"].stats.reduce_sweeps == out["fused"].stats.reduce_sweeps


def test_solve_many_golden_reference_equals_golden_and_fused():
    """Padding (mixed n in one W bucket) and host-side compaction."""
    case = GOLDEN["many"]
    graphs = [erdos_renyi(n, case["p"], case["seed0"] + i)
              for i, n in enumerate(case["sizes"])]
    out = {impl: s.solve_many(graphs) for impl, s in _sessions(case["solve_kw"]).items()}
    for batch in out.values():
        assert batch.compactions == case["compactions"]
        assert [[W, n_max, idxs] for W, n_max, idxs in batch.buckets] == case["buckets"]
        assert [_record(r) for r in batch.results] == case["results"]
    lanes = case["solve_kw"].get("lanes", 1)
    for a, b in zip(out["reference"].results, out["fused"].results):
        _same_sweeps_unless_lanes(a, b, lanes)


@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_clique_mis_reference_equals_jax_and_fused_solo_and_fpt(problem):
    """``tests/test_explore_fused.py``'s solo and decision-mode cases."""
    cases = [(erdos_renyi(16, 0.4, s), jax_erdos_renyi(16, 0.4, s),
              dict(num_workers=4, steps_per_round=8)) for s in (0, 1, 2)]
    cases.append((erdos_renyi(16, 0.45, 11), jax_erdos_renyi(16, 0.45, 11),
                  dict(num_workers=4, mode="fpt", k=3)))
    for g, jg, kw in cases:
        want = _full(JaxSession(problem=problem, config=JaxConfig(
            **kw, explore_impl="reference")).solve(jg))
        out = {impl: SolverSession(problem=problem, config=SolveConfig(
            **kw, explore_impl=impl), **CPU).solve(g) for impl in IMPLS}
        assert _full(out["reference"]) == want, (problem, kw)
        assert _full(out["fused"]) == want, (problem, kw)
        # no reduction loop: no sweeps on either route
        assert out["reference"].stats.reduce_sweeps == out["fused"].stats.reduce_sweeps == 0


@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_clique_mis_reference_equals_jax_and_fused_solve_many(problem):
    sizes = [14, 10, 16, 12]
    kw = dict(num_workers=4, steps_per_round=4, compact_threshold=0.6)
    jb = JaxSession(problem=problem, config=JaxConfig(**kw, explore_impl="reference")
                    ).solve_many([jax_erdos_renyi(n, 0.4, 3 + i) for i, n in enumerate(sizes)])
    graphs = [erdos_renyi(n, 0.4, 3 + i) for i, n in enumerate(sizes)]
    for impl in IMPLS:
        batch = SolverSession(problem=problem, config=SolveConfig(**kw, explore_impl=impl),
                              **CPU).solve_many(graphs)
        assert batch.compactions == jb.compactions, impl
        assert [_full(r) for r in batch.results] == [_full(r) for r in jb.results], impl


def test_sweeps_differ_only_by_invalid_rows(monkeypatch):
    """The multi-lane golden counts other ``reduce_sweeps`` on the two routes
    (every JAX field equal); with the masks of the rows each pop marks
    invalid emptied, which changes no JAX field, both count the same."""
    case = GOLDEN["solo"]["multi_lane_donate"]
    assert case["solve_kw"]["lanes"] > 1
    g = erdos_renyi(**case["graph"])

    def sweeps():
        out = {impl: s.solve(g) for impl, s in _sessions(case["solve_kw"]).items()}
        assert _record(out["reference"]) == _record(out["fused"]) == case["result"]
        return out["reference"].stats.reduce_sweeps, out["fused"].stats.reduce_sweeps

    ref, fused = sweeps()
    assert ref != fused

    def emptied(pop):
        def run(f, count):
            f, masks, sols, depths, valid = pop(f, count)
            return (f, torch.where(valid[..., None], masks, 0),
                    torch.where(valid[..., None], sols, 0), depths, valid)
        return run

    monkeypatch.setattr(superstep, "pop_deepest", emptied(superstep.pop_deepest))
    monkeypatch.setattr(superstep, "pop_deepest_cheap", emptied(superstep.pop_deepest_cheap))
    ref0, fused0 = sweeps()
    assert ref0 == fused0


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(6))
def test_pop_deepest_matches_the_cheap_pop(count, seed):
    """``tests/test_explore_fused.py``'s property on random depth tables of
    P workers at once (ties, empty workers, fewer tasks than lanes): the
    same valid tasks in the same order and the same post-pop active set, and
    the sorted pop equal to JAX's ``top_k`` pop vmapped over workers."""
    P, CAP, W = 6, 32, 2
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 64, W, P * CAP).reshape(P, CAP, W)
    depths = rng.integers(0, 8, size=(P, CAP)).astype(np.int32)
    active = rng.random((P, CAP)) < rng.random((P, 1)) * 0.3
    active[0] = False
    active[1] = False
    active[1, rng.integers(0, CAP)] = True  # one task, fewer than the lanes
    f = tf.Frontier(masks=t32(masks), sols=t32(masks[:, ::-1].copy()),
                    depths=torch.from_numpy(depths), active=torch.from_numpy(active),
                    overflow=torch.zeros(P, dtype=torch.bool),
                    dropped=torch.zeros(P, dtype=torch.int32))
    ref = tf.pop_deepest(f, count)
    cheap = tf.pop_deepest_cheap(f, count)
    assert torch.equal(ref[0].active, cheap[0].active)
    valid = ref[4]
    assert torch.equal(valid, cheap[4])
    for a, b in zip(ref[1:4], cheap[1:4]):
        assert torch.equal(a[valid], b[valid])
    jax_f = jf.Frontier(masks=jnp.asarray(masks), sols=jnp.asarray(masks[:, ::-1].copy()),
                        depths=jnp.asarray(depths), active=jnp.asarray(active),
                        overflow=jnp.zeros(P, bool), dropped=jnp.zeros(P, jnp.int32))
    want = jax.vmap(lambda fr: jf.pop_deepest(fr, count))(jax_f)
    assert (np.asarray(want[0].active) == ref[0].active.numpy()).all()
    for a, b in zip(want[1:], ref[1:]):
        got = b.numpy()
        assert (np.asarray(a).view(got.dtype) == got).all()
