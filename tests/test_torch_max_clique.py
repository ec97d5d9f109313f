"""Max clique and MIS in the port against the JAX package, on the CPU.

* the plain ``expand_stats_ref`` (what the CPU path runs and what the CUDA
  ``batched_expand_stats`` is held against on the card) equals the JAX
  package's jnp reference and its Pallas kernel in interpret mode, exactly,
  for one instance and, through ``inst``, for a padded batch of instances;
* the max-clique device functions, lane for lane: ``expand_tasks`` on every
  field the engine reads, ``branch_once`` and ``bound``, on random graphs
  (n <= 128, W <= 4) with empty, full and single-vertex lanes;
* solo solves of both problems equal the JAX package's, bnb and fpt (hit
  and miss), and their sequential references agree with the JAX package's;
* the Gallai identities mis(G) = n - vc(G) and clique(G) = mis(complement(G));
* the fused expansion ``clique_expand_ref`` (what the CPU path runs, and
  what the CUDA ``clique_expand`` kernel is held against on the card) gives
  every output of JAX's ``expand_tasks``, on the graph and on its
  complement (MIS), for one instance and a padded batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32, u32

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.graphs.bitgraph import BitGraph
from repro.graphs.generators import erdos_renyi
from repro.kernels.bitset_ops.kernel import batched_expand_stats as jax_kernel
from repro.kernels.bitset_ops.ref import expand_stats_ref as jax_ref
from repro.problems import base as jb
from repro.problems import max_clique as jmc
from repro.problems import sequential as jseq
from repro.problems.registry import get_problem
from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs import bitgraph as tbg
from repro_torch.graphs.bitgraph import mask_full, n_words
from repro_torch.kernels import counts
from repro_torch.kernels.bitset_ops import (
    batched_degrees,
    batched_expand_stats,
    clique_expand,
    clique_expand_ref,
    expand_stats_op,
    expand_stats_ref,
)
from repro_torch.problems import base as tb
from repro_torch.problems import max_clique as tmc
from repro_torch.problems import sequential as tseq
from repro_torch.problems.registry import get_problem as get_torch_problem

JAX_MC = get_problem("max_clique")
TORCH_MC = get_torch_problem("max_clique")

FIELDS = ("best_size", "rounds", "nodes_expanded", "tasks_transferred", "found")
STATS = ("overflow", "overflow_count", "control_bytes_per_round",
         "transfer_rounds", "transfer_bytes_total", "transfer_bytes_per_round")


def _task_rows(n, T, seed):
    """(masks, sols): random rows, then an empty, a full and a single-vertex
    (bit 31 where it exists) mask; sols random, empty and full."""
    rng = np.random.default_rng(seed)
    W = n_words(n)
    masks = random_masks(rng, n, W, T)
    sols = random_masks(rng, n, W, T)
    special = [np.zeros(W, np.uint32), mask_full(n), np.zeros(W, np.uint32)]
    special[2][min(31, n - 1) // 32] = np.uint32(1) << np.uint32(min(31, n - 1) % 32)
    for i, row in enumerate(special[:T]):
        masks[i] = row
    sols[0] = 0
    if T > 1:
        sols[1] = mask_full(n)
    return masks, sols


# -- the plain panel vs the JAX reference and its interpret-mode kernel --------


@pytest.mark.parametrize("n,T", [(1, 1), (31, 2), (33, 9), (100, 7), (128, 16), (300, 5)])
def test_expand_stats_ref_matches_jax(n, T):
    g = erdos_renyi(n, min(1.0, 8.0 / max(n - 1, 1)), 3000 + n)
    masks, sols = _task_rows(n, T, n + T)
    adj = jnp.asarray(g.adj)
    want_ref = jax_ref(adj, jnp.asarray(masks), jnp.asarray(sols))
    want_deg, want_pc = jax_kernel(adj, jnp.asarray(masks), jnp.asarray(sols), interpret=True)
    assert (np.asarray(want_deg) == np.asarray(want_ref[0])).all()
    got = expand_stats_ref(t32(g.adj), t32(masks), t32(sols))
    assert all(x.dtype == torch.int32 for x in got)
    for a, b in zip(got, want_ref):
        assert (a.numpy() == np.asarray(b)).all()
    assert (got[0].numpy() == np.asarray(want_deg)).all()
    assert (torch.stack(got[1:], 1).numpy() == np.asarray(want_pc)).all()
    # the wrappers on CPU tensors take the plain version and launch nothing
    counts.reset()
    deg, pc = batched_expand_stats(t32(g.adj), t32(masks), t32(sols))
    assert torch.equal(deg, got[0]) and (pc.numpy() == np.asarray(want_pc)).all()
    op = expand_stats_op(t32(g.adj), t32(masks), t32(sols))
    assert all(torch.equal(a, b) for a, b in zip(op, got))
    assert counts.snapshot() == {}


@pytest.mark.parametrize("sizes,T", [((20, 12, 31), 9), ((40, 64, 33), 12), ((5,), 4)])
def test_instance_axis_matches_jax_per_instance(sizes, T):
    """A padded (B, n_max, W) batch with a task-row map gives, row by row,
    the JAX panels of each row's own (unpadded) instance; padding vertices
    are never in a mask and get -1."""
    graphs = [erdos_renyi(n, 0.2, 50 + i) for i, n in enumerate(sizes)]
    n_max = max(sizes)
    W = n_words(n_max)
    adj = np.zeros((len(graphs), n_max, W), np.uint32)
    rng = np.random.default_rng(T)
    inst = rng.integers(0, len(graphs), size=T).astype(np.int32)
    inst[: len(graphs)] = np.arange(len(graphs))
    masks = np.zeros((T, W), np.uint32)
    sols = np.zeros((T, W), np.uint32)
    for b, g in enumerate(graphs):
        adj[b, : g.n, : g.W] = g.adj
    for t, b in enumerate(inst):
        m, s = _task_rows(graphs[b].n, 3, 7 * t + 1)
        masks[t, : graphs[b].W] = m[t % 3]
        sols[t, : graphs[b].W] = s[(t + 1) % 3]
    deg, pc_mask, pc_sol = expand_stats_ref(t32(adj), t32(masks), t32(sols), torch.from_numpy(inst))
    assert torch.equal(deg, batched_degrees(t32(adj), t32(masks), torch.from_numpy(inst)))
    for t, b in enumerate(inst):
        g = graphs[b]
        m, s = masks[t : t + 1, : g.W], sols[t : t + 1, : g.W]
        wdeg, wpc = jax_kernel(jnp.asarray(g.adj), jnp.asarray(m), jnp.asarray(s), interpret=True)
        assert (deg[t, : g.n].numpy() == np.asarray(wdeg)[0]).all()
        assert (deg[t, g.n :] == -1).all()
        assert [int(pc_mask[t]), int(pc_sol[t])] == np.asarray(wpc)[0].tolist()
    # a batch without a row map is refused, not read as instance 0
    if len(graphs) > 1:
        with pytest.raises(ValueError, match="inst is required"):
            batched_degrees(t32(adj), t32(masks))
        data = tb.ProblemData(n=np.array(sizes, np.int32), adj=t32(adj))
        with pytest.raises(ValueError, match="for_task_rows"):
            tb.degrees_batch(data, t32(masks))


# -- the max-clique device functions, lane for lane -----------------------------


def _cycle(n):
    return BitGraph.from_edges(n, [(i, (i + 1) % n) for i in range(n)])


GRAPHS = {
    "gnp20": lambda: erdos_renyi(20, 0.4, 3),
    "gnp45": lambda: erdos_renyi(45, 0.3, 4),
    "gnp100": lambda: erdos_renyi(100, 0.2, 5),
    "gnp128": lambda: erdos_renyi(128, 0.25, 6),
    "cycle12": lambda: _cycle(12),
    "complete9": lambda: BitGraph.from_dense(np.ones((9, 9), bool)),
}


def _lanes(g, seed, L=12):
    masks, sols = _task_rows(g.n, L, seed)
    return masks, sols & ~masks  # a clique and its candidates are disjoint


def _same_step(tstep, jstep):
    for field in jb.BranchStep._fields:
        want = np.asarray(getattr(jstep, field))
        got = getattr(tstep, field)
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert (got == want).all(), field


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_expand_tasks_per_lane(name):
    g = GRAPHS[name]()
    masks, sols = _lanes(g, 41)
    jdata = jb.make_data(JAX_MC, g)
    jex = jax.jit(lambda m, s: jmc.expand_tasks(jdata, m, s))(masks, sols)
    data = tb.make_data(TORCH_MC, g, "cpu")
    tex = tmc.expand_tasks(data, t32(masks), t32(sols))
    _same_step(tex.step, jex.step)
    live = ~tex.step.is_terminal.numpy()
    for field in ("bound", "left_bound", "right_bound"):
        got = getattr(tex, field).numpy()
        assert (got == np.asarray(getattr(jex, field))).all(), field
        assert got.dtype == np.int32
    # the composed per-task JAX path agrees on every value the engine reads
    vm = jax.vmap
    jstep = vm(lambda m, s: jmc.branch_once(jdata, m, s))(masks, sols)
    _same_step(tex.step, jstep)
    assert (tex.bound.numpy() == np.asarray(vm(lambda m, s: jmc.bound(jdata, m, s))(masks, sols))).all()
    for side in ("left", "right"):
        want = vm(lambda m, s: jmc.bound(jdata, m, s))(
            getattr(jstep, f"{side}_mask"), getattr(jstep, f"{side}_sol"))
        got = getattr(tex, f"{side}_bound").numpy()
        assert (got[live] == np.asarray(want)[live]).all(), side
    # and the port's own per-batch callables, composed, give the same
    cex = tb.compose_expand_tasks(TORCH_MC)(data, t32(masks), t32(sols))
    assert torch.equal(cex.bound, tex.bound)
    for a, b in zip(cex.step, tex.step):
        assert torch.equal(a, b)
    lv = torch.from_numpy(live)
    assert torch.equal(cex.left_bound[lv], tex.left_bound[lv])
    assert torch.equal(cex.right_bound[lv], tex.right_bound[lv])


def test_expand_tasks_on_a_padded_batch_reads_each_instance():
    """Lanes of three instances in one (B, n_max, W) batch expand exactly
    as each instance alone (the JAX package vmaps over instances)."""
    graphs = [erdos_renyi(n, 0.35, 60 + n) for n in (40, 57, 33)]
    rows = 5
    per = [_lanes(g, 9 + i, rows) for i, g in enumerate(graphs)]
    W = n_words(57)
    spec = TORCH_MC
    data = tb.for_task_rows(tb.make_batch_data(spec, graphs, 57, W, "cpu"), rows)
    masks = np.concatenate([m for m, _ in per])
    sols = np.concatenate([s for _, s in per])
    tex = tmc.expand_tasks(data, t32(masks), t32(sols))
    for b, (g, (m, s)) in enumerate(zip(graphs, per)):
        jex = jmc.expand_tasks(jb.make_data(JAX_MC, g), m, s)
        sl = slice(b * rows, (b + 1) * rows)
        for field in ("bound", "left_bound", "right_bound"):
            assert (getattr(tex, field)[sl].numpy() == np.asarray(getattr(jex, field))).all()
        for field in jb.BranchStep._fields:
            want = np.asarray(getattr(jex.step, field))
            got = getattr(tex.step, field)[sl]
            got = u32(got) if want.dtype == np.uint32 else got.numpy()
            assert (got == want).all(), (b, field)


@pytest.mark.parametrize("n", [8, 33])
def test_pivot_ties_take_the_first_vertex(n):
    """On a complete graph every candidate ties: the pivot is the first
    vertex of the mask, as ``jnp.argmax`` picks."""
    g = BitGraph.from_dense(np.ones((n, n), bool))
    masks = np.stack([mask_full(n), mask_full(n)])
    masks[1, 0] &= ~np.uint32(1)
    sols = np.zeros_like(masks)
    step = tmc.branch_once(tb.make_data(TORCH_MC, g, "cpu"), t32(masks), t32(sols))
    assert u32(step.left_sol)[:, 0].tolist() == [1, 2]


# -- solo solves and the sequential references ----------------------------------


def _same_result(jr, tr):
    for name in FIELDS:
        assert getattr(tr, name) == getattr(jr, name), name
    if jr.best_sol is None:
        assert tr.best_sol is None
    else:
        assert (np.asarray(tr.best_sol) == np.asarray(jr.best_sol)).all()
    for name in STATS:
        assert getattr(tr.stats, name) == getattr(jr.stats, name), name


@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_solo_solves_match_jax(problem):
    kw = dict(num_workers=5, steps_per_round=4, lanes=2, donate_k=2, chunk_rounds=3)
    jax_session = JaxSession(problem=problem, config=JaxConfig(**kw))
    torch_session = SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu")
    seq = {"max_clique": tseq.solve_sequential_max_clique, "mis": tseq.solve_sequential_mis}[problem]
    verify = {"max_clique": tseq.verify_clique, "mis": tseq.verify_independent_set}[problem]
    for seed in range(3):
        g = erdos_renyi(36, 0.3, 700 + seed)
        tr = torch_session.solve(g)
        _same_result(jax_session.solve(g), tr)
        assert tr.best_size == seq(g)[0] and verify(g, tr.best_sol)


@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_fpt_hit_and_miss_match_jax(problem):
    g = erdos_renyi(16, 0.45, 11)
    seq = {"max_clique": tseq.solve_sequential_max_clique, "mis": tseq.solve_sequential_mis}[problem]
    opt, _, _ = seq(g)
    for k in (opt, opt + 1):
        cfg = dict(num_workers=4, mode="fpt", k=k)
        tr = SolverSession(problem=problem, config=SolveConfig(**cfg), device="cpu").solve(g)
        _same_result(JaxSession(problem=problem, config=JaxConfig(**cfg)).solve(g), tr)
        if k == opt:
            assert tr.best_size >= opt
        else:
            assert tr.best_size == -1 and tr.best_sol is None


@pytest.mark.parametrize("seed", range(4))
def test_sequential_references_match_jax(seed):
    g = erdos_renyi(18, 0.3 + 0.05 * seed, 90 + seed)
    tg = tbg.BitGraph(n=g.n, adj=g.adj)
    for jfn, tfn in ((jseq.solve_sequential_max_clique, tseq.solve_sequential_max_clique),
                     (jseq.solve_sequential_mis, tseq.solve_sequential_mis)):
        for kw in (dict(), dict(mode="fpt", k=4)):
            jbest, jsol, jst = jfn(g, **kw)
            tbest, tsol, tst = tfn(tg, **kw)
            assert tbest == jbest and vars(tst) == vars(jst)
            assert (jsol is None and tsol is None) or (tsol == jsol).all()
    assert tseq.verify_clique(tg, tseq.solve_sequential_max_clique(tg)[1])
    assert tseq.verify_independent_set(tg, tseq.solve_sequential_mis(tg)[1])


def test_gallai_identities():
    """mis(G) = n - vc(G) and clique(G) = mis(complement(G)), all on the port."""
    g = erdos_renyi(15, 0.35, 7)
    kw = dict(num_workers=4, steps_per_round=8)

    def best(problem, graph):
        return SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu").solve(graph).best_size

    tg = tbg.BitGraph(n=g.n, adj=g.adj)
    assert best("mis", tg) == g.n - best("vertex_cover", tg)
    assert best("max_clique", tg) == best("mis", tbg.complement(tg))


def test_registry_names_and_aliases():
    assert get_torch_problem("clique").name == "max_clique"
    assert get_torch_problem("independent_set").name == "mis"
    assert get_torch_problem("maximum_independent_set").name == "mis"
    with pytest.raises(ValueError, match="max_clique"):
        get_torch_problem("knapsack")


# -- the fused expansion (clique_expand_ref) -------------------------------------


def _assert_clique_expand_equal(out, jex, rows=slice(None)):
    for field in ("bound", "left_bound", "right_bound"):
        assert (getattr(out, field)[rows].numpy() == np.asarray(getattr(jex, field))).all(), field
    for field in jb.BranchStep._fields:
        want = np.asarray(getattr(jex.step, field))
        got = getattr(out, field)[rows]
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert (got == want).all(), field
    assert out.sweeps is None


@pytest.mark.parametrize("complemented", [False, True], ids=["clique", "mis"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_clique_expand_ref_matches_jax(name, complemented):
    g = GRAPHS[name]()
    if complemented:  # MIS branches like max clique on the complement
        g = BitGraph.from_dense(~g.to_dense() & ~np.eye(g.n, dtype=bool))
    masks, sols = _lanes(g, 61)
    jex = jmc.expand_tasks(jb.make_data(JAX_MC, g), masks, sols)
    counts.reset()
    out = clique_expand(t32(g.adj), t32(masks), t32(sols))
    assert counts.snapshot() == {}  # a CPU tensor takes the plain version
    _assert_clique_expand_equal(out, jex)


def test_clique_expand_ref_on_a_padded_mis_batch():
    """The complements of three instances in one padded batch, rows
    interleaved by a row map, expand as each instance alone (MIS)."""
    graphs = [erdos_renyi(n, 0.3, 80 + n) for n in (40, 70, 33)]
    views = [tbg.complement(tbg.BitGraph(g.n, g.adj)) for g in graphs]
    W = n_words(70)
    adj = np.zeros((3, 70, W), np.uint32)
    per = []
    for b, v in enumerate(views):
        adj[b, : v.n, : v.W] = v.adj
        per.append(_lanes(v, 20 + b, 6))
    inst = np.repeat(np.arange(3, dtype=np.int32), 6)
    order = np.random.default_rng(3).permutation(18)
    masks = np.concatenate([np.pad(m, ((0, 0), (0, W - m.shape[1]))) for m, _ in per])[order]
    sols = np.concatenate([np.pad(s, ((0, 0), (0, W - s.shape[1]))) for _, s in per])[order]
    inst = inst[order]
    out = clique_expand_ref(t32(adj), t32(masks), t32(sols), torch.from_numpy(inst))
    for b, v in enumerate(views):
        sel = torch.from_numpy(np.nonzero(inst == b)[0])
        jg = BitGraph(v.n, np.asarray(v.adj, np.uint32))
        jex = jmc.expand_tasks(jb.make_data(JAX_MC, jg), masks[sel.numpy(), : v.W],
                               sols[sel.numpy(), : v.W])
        sub = out._replace(**{f: getattr(out, f)[sel][..., : v.W] if getattr(out, f).dim() == 2
                              else getattr(out, f)[sel]
                              for f in out._fields if getattr(out, f) is not None})
        _assert_clique_expand_equal(sub, jex)
