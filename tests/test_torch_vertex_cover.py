"""Per-lane parity of the vertex-cover device functions with the JAX package.

The JAX functions work on one task and are vmapped over lanes; the port's
work on a batch of lanes.  Every lane must agree exactly on random graphs
(n <= 128, W <= 4) and on tie-heavy ones (cycles, complete graphs), with
empty masks and terminal lanes in every batch.  Hazards named here:

* reduce to fixpoint: the port runs whole-batch sweeps until no lane
  changes, checking every few sweeps; a sweep past a lane's fixpoint is a
  no-op, so the check interval cannot change a result;
* ties in the pivot: the first vertex of maximum degree, as ``jnp.argmax``;
* the fused expansion ``vc_expand_ref`` (what the CPU path runs, and what
  the CUDA ``vc_expand`` kernel is held against on the card) gives every
  output of JAX's ``expand_tasks`` and each lane's trip count of JAX's
  ``reduce_instance`` loop, for one instance and a padded batch of three.
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
from repro_torch.kernels import counts
from repro_torch.kernels.bitset_ops import ref as tref
from repro_torch.kernels.bitset_ops import vc_expand
from repro_torch.problems import base as tb
from repro_torch.problems import vertex_cover as tvc
from repro_torch.problems.registry import get_problem as get_torch_problem

JAX_VC = get_problem("vertex_cover")
TORCH_VC = get_torch_problem("vertex_cover")


def _cycle(n):
    return BitGraph.from_edges(n, [(i, (i + 1) % n) for i in range(n)])


def _complete(n):
    return BitGraph.from_dense(np.ones((n, n), bool))


def _windmill(k):
    """k triangles sharing vertex 0: every other vertex has degree 2 and
    adjacent neighbours, so rule 3 fires first."""
    edges = []
    for i in range(k):
        a, b = 2 * i + 1, 2 * i + 2
        edges += [(0, a), (0, b), (a, b)]
    return BitGraph.from_edges(2 * k + 1, edges)


def _path(n):
    return BitGraph.from_edges(n, [(i, i + 1) for i in range(n - 1)])


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


def _jax_trips(g, masks, sols):
    """Each lane's trip count of JAX's ``reduce_instance`` loop, from a
    single-lane loop of its ``_reduce_step``: the sweeps run until the first
    one that changes nothing (included), at most n + 1."""
    data = jb.make_data(JAX_VC, g)
    step = jax.jit(lambda m, s: jvc._reduce_step(data, m, s))
    trips = []
    for m, s in zip(masks, sols):
        t, changed = 0, True
        while changed and t < data.adj.shape[0] + 1:
            m, s, changed = step(m, s)
            changed = bool(changed)
            t += 1
        trips.append(t)
    return np.array(trips, np.int32)


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
    m2, s2, changed = tref.vc_reduce_step(data.adj, tm, ts)
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
    # the JAX package's per-lane while_loop: the largest lane's trip count
    assert counters.reduce_sweeps == _jax_trips(g, masks, sols).max() > 0


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


# -- the fused expansion (vc_expand_ref) -----------------------------------------

EXPAND_GRAPHS = {
    **GRAPHS,
    "windmill7": lambda: _windmill(7),  # rule 3, and ties on degree 2
    "path70": lambda: _path(70),  # rule 2 one vertex a sweep: a long chain
    "sparse60": lambda: erdos_renyi(60, 0.06, 9),  # long rule-2 chains
    **{f"fresh{seed}": (lambda seed=seed: erdos_renyi(
        int(np.random.default_rng(seed).integers(2, 129)), 0.03 + 0.02 * seed, 100 + seed))
       for seed in range(4)},
}


def _expand_lanes(g, seed):
    """_batch's lanes plus a single bit 31 (or the last vertex) and sols
    disjoint from the masks."""
    masks, sols = _batch(g, seed, L=14)
    v = min(31, g.n - 1)
    masks[3] = 0
    masks[3, v // 32] = np.uint32(1) << np.uint32(v % 32)
    return masks, sols & ~masks


def _assert_expand_equal(out, jex, jsol, trips, rows=slice(None)):
    for field in ("bound", "left_bound", "right_bound"):
        got = getattr(out, field)[rows].numpy()
        assert (got == np.asarray(getattr(jex, field))).all(), field
    for field in jb.BranchStep._fields:
        want = np.asarray(getattr(jex.step, field))
        got = getattr(out, field)[rows]
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert (got == want).all(), field
    assert (u32(out.terminal_sol[rows]) == np.asarray(jsol)).all()
    assert (out.sweeps[rows].numpy() == trips).all()


@pytest.mark.parametrize("name", sorted(EXPAND_GRAPHS))
def test_vc_expand_ref_matches_jax(name):
    g = EXPAND_GRAPHS[name]()
    masks, sols = _expand_lanes(g, 53)
    jdata = jb.make_data(JAX_VC, g)
    jex = jax.jit(lambda m, s: jvc.expand_tasks(jdata, m, s))(masks, sols)
    _, jsol = _jax_lanes(jvc.reduce_instance, g, masks, sols)
    trips = _jax_trips(g, masks, sols)
    counts.reset()
    out = vc_expand(t32(g.adj), t32(masks), t32(sols))
    assert counts.snapshot() == {}  # a CPU tensor takes the plain version
    _assert_expand_equal(out, jex, jsol, trips)
    # the reduction alone agrees with it
    rm, rs, sweeps = tref.vc_reduce(t32(g.adj), t32(masks), t32(sols))
    jm, _ = _jax_lanes(jvc.reduce_instance, g, masks, sols)
    assert (u32(rm) == np.asarray(jm)).all() and torch.equal(rs, out.terminal_sol)
    assert torch.equal(sweeps, out.sweeps)


def test_rule_3_fires_on_a_windmill():
    g = _windmill(4)
    data, m, s = _both(g, mask_full(g.n)[None], np.zeros((1, g.W), np.uint32))
    m2, s2, changed = tref.vc_reduce_step(data.adj, m, s)
    # no isolated and no degree-1 vertex: vertex 1's neighbours 0 and 2 join
    assert bool(changed[0]) and u32(s2)[0, 0] == 0b101
    assert u32(m2)[0, 0] == u32(m)[0, 0] & ~np.uint32(0b111)


@pytest.mark.parametrize("sizes", [(40, 57, 33), (60, 20, 61)])
def test_vc_expand_ref_on_a_padded_batch(sizes):
    """Lanes of three instances in one (B, n_max, W) batch with a row map
    expand as each instance alone, trip counts included."""
    graphs = [erdos_renyi(n, 0.07, 70 + n) for n in sizes]
    n_max = max(sizes)
    W = n_words(n_max)
    adj = np.zeros((3, n_max, W), np.uint32)
    rows = []
    for b, g in enumerate(graphs):
        adj[b, : g.n, : g.W] = g.adj
        rows.append(_expand_lanes(g, 90 + b))
    inst = np.concatenate([np.full(len(r[0]), b, np.int32) for b, r in enumerate(rows)])
    rng = np.random.default_rng(sum(sizes))
    order = rng.permutation(len(inst))  # rows of the instances interleaved
    masks = np.zeros((len(inst), W), np.uint32)
    sols = np.zeros((len(inst), W), np.uint32)
    allm = [np.pad(r[0], ((0, 0), (0, W - r[0].shape[1]))) for r in rows]
    alls = [np.pad(r[1], ((0, 0), (0, W - r[1].shape[1]))) for r in rows]
    masks[:], sols[:] = np.concatenate(allm)[order], np.concatenate(alls)[order]
    inst = inst[order]
    out = tref.vc_expand_ref(t32(adj), t32(masks), t32(sols), torch.from_numpy(inst))
    for b, g in enumerate(graphs):
        sel = np.nonzero(inst == b)[0]
        m, s = masks[sel, : g.W], sols[sel, : g.W]
        jex = jvc.expand_tasks(jb.make_data(JAX_VC, g), m, s)
        _, jsol = _jax_lanes(jvc.reduce_instance, g, m, s)
        sub = tref.ExpandOut(*(None if f is None else f[torch.from_numpy(sel)][..., : g.W]
                               if f.dim() == 2 else f[torch.from_numpy(sel)] for f in out))
        _assert_expand_equal(sub, jex, jsol, _jax_trips(g, m, s))
        # words past the instance's own ones stay empty
        for f in ("left_mask", "left_sol", "right_mask", "right_sol", "terminal_sol"):
            assert (getattr(out, f)[torch.from_numpy(sel)][:, g.W:] == 0).all()


def test_expand_tasks_counts_the_largest_trip_count():
    g = erdos_renyi(60, 0.06, 9)
    masks, sols = _expand_lanes(g, 5)
    data, m, s = _both(g, masks, sols)
    counters = tb.WorkCounters()
    tvc.expand_tasks(data, m, s, counters)
    tvc.expand_tasks(data, m[:3], s[:3], counters)
    trips = _jax_trips(g, masks, sols)
    assert counters.reduce_sweeps == trips.max() + trips[:3].max()


def test_flush_sums_each_rounds_largest_trip_count():
    """The card's pending trip counts (rounds of different lane counts) fold
    into the same number the CPU route counts round by round."""
    rounds = [torch.tensor(r, dtype=torch.int32) for r in ([1, 3], [2, 2, 5], [4])]
    pending = tb.WorkCounters(reduce_sweeps=7)
    pending._pending = list(rounds)
    pending.flush()
    direct = tb.WorkCounters(reduce_sweeps=7)
    for r in rounds:
        direct.add_sweeps(r)
    assert pending.reduce_sweeps == direct.reduce_sweeps == 7 + 3 + 5 + 4
    assert pending._pending == []
    pending.flush()  # nothing pending: nothing changes
    assert pending.reduce_sweeps == 19
