"""Per-lane parity of the vertex-cover device functions with the JAX package.

The JAX functions work on one task and are vmapped over lanes; the port's
work on a batch of lanes.  Every lane must agree exactly on random graphs
(n <= 128, W <= 4) and on tie-heavy ones (cycles, complete graphs), with
empty masks and terminal lanes in every batch.  Hazards named here:

* reduce to fixpoint: the port runs whole-batch sweeps until no lane
  changes, checking every few sweeps; a sweep past a lane's fixpoint is a
  no-op, so the check interval cannot change a result;
* ties in the pivot: the first vertex of maximum degree, as ``jnp.argmax``.
"""

import jax
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32, u32

from repro.graphs.bitgraph import BitGraph
from repro.graphs.generators import erdos_renyi
from repro.problems import base as jb
from repro.problems import vertex_cover as jvc
from repro.problems.registry import get_problem
from repro_torch.graphs.bitgraph import mask_full, n_words
from repro_torch.problems import base as tb
from repro_torch.problems import vertex_cover as tvc
from repro_torch.problems.registry import get_problem as get_torch_problem

JAX_VC = get_problem("vertex_cover")
TORCH_VC = get_torch_problem("vertex_cover")


def _cycle(n):
    return BitGraph.from_edges(n, [(i, (i + 1) % n) for i in range(n)])


def _complete(n):
    return BitGraph.from_dense(np.ones((n, n), bool))


GRAPHS = {
    "gnp20": lambda: erdos_renyi(20, 0.2, 3),
    "gnp45": lambda: erdos_renyi(45, 0.1, 4),
    "gnp100": lambda: erdos_renyi(100, 0.05, 5),
    "gnp128": lambda: erdos_renyi(128, 0.04, 6),
    "cycle12": lambda: _cycle(12),
    "triangle": lambda: _cycle(3),
    "complete9": lambda: _complete(9),
}


def _batch(g, seed, L=12):
    """Random (masks, sols) plus an empty lane, a full lane and a terminal
    lane (one vertex, no edges)."""
    rng = np.random.default_rng(seed)
    W = n_words(g.n)
    masks = random_masks(rng, g.n, W, L)
    sols = random_masks(rng, g.n, W, L) & ~masks
    masks[0] = 0
    masks[1] = mask_full(g.n)
    sols[1] = 0
    masks[2] = 0
    masks[2, 0] = 1  # a single vertex: nothing to cover, a terminal lane
    return masks, sols


def _jax_lanes(fn, g, masks, sols):
    data = jb.make_data(JAX_VC, g)
    return jax.jit(jax.vmap(lambda m, s: fn(data, m, s)))(masks, sols)


def _both(g, masks, sols):
    return tb.make_data(TORCH_VC, g, "cpu"), t32(masks), t32(sols)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reduce_instance_per_lane(name):
    g = GRAPHS[name]()
    masks, sols = _batch(g, 11)
    jm, js = _jax_lanes(jvc.reduce_instance, g, masks, sols)
    data, m, s = _both(g, masks, sols)
    tm, ts = tvc.reduce_instance(data, m, s)
    assert (u32(tm) == np.asarray(jm)).all()
    assert (u32(ts) == np.asarray(js)).all()
    # past the fixpoint a sweep changes nothing
    m2, s2, changed = tvc._reduce_step(data, tm, ts)
    assert not bool(changed.any())
    assert torch.equal(m2, tm) and torch.equal(s2, ts)


@pytest.mark.parametrize("every", [1, 3, 64])
def test_reduce_check_interval_changes_nothing(monkeypatch, every):
    g = erdos_renyi(60, 0.06, 9)  # sparse: long rule-2 chains
    masks, sols = _batch(g, 5)
    data, m, s = _both(g, masks, sols)
    want = tvc.reduce_instance(data, m, s)
    monkeypatch.setattr(tvc, "REDUCE_CHECK_EVERY", every)
    counters = tb.WorkCounters()
    got = tvc.reduce_instance(data, m, s, counters)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert counters.reduce_sweeps % every == 0 and counters.reduce_sweeps > 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_branch_once_and_bounds_per_lane(name):
    g = GRAPHS[name]()
    masks, sols = _batch(g, 23)
    data, m, s = _both(g, masks, sols)
    jstep = _jax_lanes(jvc.branch_once, g, masks, sols)
    tstep = tvc.branch_once(data, m, s)
    for field in jb.BranchStep._fields:
        want = np.asarray(getattr(jstep, field))
        got = getattr(tstep, field)
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert (got == want).all(), field
    jbound = _jax_lanes(jvc.task_bound, g, masks, sols)
    assert (tvc.task_bound(data, m, s).numpy() == np.asarray(jbound)).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_expand_tasks_per_lane(name):
    g = GRAPHS[name]()
    masks, sols = _batch(g, 37)
    jdata = jb.make_data(JAX_VC, g)
    jex = jax.jit(lambda m, s: jvc.expand_tasks(jdata, m, s))(masks, sols)
    data, m, s = _both(g, masks, sols)
    tex = tvc.expand_tasks(data, m, s)
    for field in ("bound", "left_bound", "right_bound"):
        assert (getattr(tex, field).numpy() == np.asarray(getattr(jex, field))).all(), field
    for field in jb.BranchStep._fields:
        want = np.asarray(getattr(jex.step, field))
        got = getattr(tex.step, field)
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert (got == want).all(), field
    # the composed per-batch callables (the fallback of resolve_expand) give
    # the same expansion on every value the engine reads
    cex = tb.compose_expand_tasks(TORCH_VC)(data, m, s)
    live = ~tex.step.is_terminal
    assert torch.equal(cex.bound, tex.bound)
    for a, b in zip(cex.step, tex.step):
        assert torch.equal(a, b)
    assert torch.equal(cex.left_bound[live], tex.left_bound[live])
    assert torch.equal(cex.right_bound[live], tex.right_bound[live])


@pytest.mark.parametrize("n", [8, 9, 33])
def test_pivot_ties_take_the_first_vertex(n):
    """Every vertex of a cycle or a complete graph ties on degree and no
    rule fires (n > 3), so the pivot is the first vertex of the mask."""
    for g in (_cycle(n), _complete(n)):
        masks = np.stack([mask_full(n), mask_full(n)])
        if g.num_edges > n:  # complete: without vertex 0 it stays complete
            masks[1, 0] &= ~np.uint32(1)
        sols = np.zeros_like(masks)
        data, m, s = _both(g, masks, sols)
        step = tvc.branch_once(data, m, s)
        jstep = _jax_lanes(jvc.branch_once, g, masks, sols)
        assert (u32(step.left_sol) == np.asarray(jstep.left_sol)).all()
        assert u32(step.left_sol)[0, 0] == 1  # u = 0
        if g.num_edges > n:
            assert u32(step.left_sol)[1, 0] == 2  # u = 1
