"""The plain reference against the port's own plain versions on the CPU:
the expansions and the superstep agree field for field, the clique solver
with brute force, and the certificates catch broken answers."""

import itertools

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfbench import instances
from perfbench.reference import bits, expand
from perfbench.reference import superstep as ref_superstep
from perfbench.reference.problems import max_clique, vertex_cover

PROBLEMS = {"vertex_cover": vertex_cover, "max_clique": max_clique}


def _program_inputs(problem, n, B, R, density, seed):
    from repro_torch.graphs.bitgraph import BitGraph

    rng = np.random.default_rng(seed)
    W = (n + 31) // 32
    N = 32 * W
    dense = [instances.gnp(n - 3 * b, 4 + 8 * density, seed + b) for b in range(B)]
    adj = np.zeros((B, N, W), np.uint32)
    for b, d in enumerate(dense):
        g = BitGraph.from_dense(d)
        adj[b, : g.n, : g.W] = g.adj
    sizes = torch.tensor([d.shape[0] for d in dense]).repeat_interleave(R)
    inside = torch.arange(N)[None, :] < sizes[:, None]
    m = torch.from_numpy(rng.random((B * R, N)) < density) & inside
    s = torch.from_numpy(rng.random((B * R, N)) < 0.1) & inside & ~m
    m[0] = False  # an empty row: a terminal task
    return dense, torch.from_numpy(adj.view(np.int32)), m, s, W


@pytest.mark.parametrize("problem", ["vertex_cover", "max_clique"])
@pytest.mark.parametrize("density", [0.2, 0.6, 0.95])
def test_expansion_equals_program_plain_version(problem, density):
    from repro_torch.kernels.bitset_ops import ref

    B, R = 3, 8
    dense, adj, m, s, W = _program_inputs(problem, 70, B, R, density, 11)
    prog = {"vertex_cover": ref.vc_expand_ref, "max_clique": ref.clique_expand_ref}[problem]
    out = prog(adj, bits.pack(m), bits.pack(s), (torch.arange(B * R) // R).int())
    N = 32 * W
    got = {k: (bits.unpack(v).view(B, R, N) if v.dim() == 2 else v.view(B, R))
           for k, v in out._asdict().items() if v is not None}
    mine = PROBLEMS[problem].expand(bits.padded_adjacency(dense, W, "cpu"),
                                    m.view(B, R, N), s.view(B, R, N))
    for k, v in got.items():
        assert torch.equal(mine[k], v.to(mine[k].dtype)), k
    assert not expand.rows_differ(mine, got).any()
    got["bound"][1, 2] += 1
    assert expand.rows_differ(mine, got).sum() == 1


def _leaves(st):
    d = {f"frontier.{k}": v for k, v in st.frontier._asdict().items()}
    d.update({k: v for k, v in st._asdict().items() if k != "frontier"})
    return d


@pytest.mark.parametrize("problem,n,avg", [("vertex_cover", 60, 4.0), ("vertex_cover", 45, 6.6),
                                           ("max_clique", 50, 19.6)])
def test_superstep_follows_the_program(problem, n, avg):
    from repro_torch.core import engine
    from repro_torch.core import superstep as ss
    from repro_torch.graphs.bitgraph import BitGraph
    from repro_torch.problems import base
    from repro_torch.problems.registry import get_problem

    spec = get_problem(problem)
    dense = instances.gnp(n, avg, 3)
    g = BitGraph.from_dense(dense)
    P, W = 8, g.W
    st = engine.make_instance_state(spec, g, P, 4 * 32 * W + 8, W,
                                    base.initial_bound(spec, g, "bnb", None), "cpu")
    data = base.make_data(spec, g, "cpu")
    A = bits.padded_adjacency([dense], W, "cpu")
    knobs = dict(steps_per_round=4, lanes=1, policy="priority", packed_status=True,
                 skip_empty_transfer=True, transfer_impl="sparse", donate_k=1)
    moved = 0
    for _ in range(6):
        out, done = ss.superstep(spec, data, st, steps_per_round=4, lanes=1)
        ref, ref_done = ref_superstep.superstep(PROBLEMS[problem].expand, A, _leaves(st),
                                                knobs)
        assert ref_superstep.leaves_differ(ref, _leaves(out)) == []
        assert ref_done == bool(done[0])
        moved += int(out.tasks_sent.sum())
        st = out
        if ref_done:
            break
    bad = _leaves(st)
    bad["nodes_expanded"] = bad["nodes_expanded"] + 1
    assert "nodes_expanded" in ref_superstep.leaves_differ(_leaves(st), bad)


def _brute_clique(dense):
    n = dense.shape[0]
    for k in range(n, 0, -1):
        for c in itertools.combinations(range(n), k):
            if all(dense[a, b] for a, b in itertools.combinations(c, 2)):
                return k
    return 0


@pytest.mark.parametrize("seed", range(4))
def test_max_clique_size_equals_brute_force(seed):
    dense = instances.p_hat(14, 0.2, 0.8, seed)
    assert max_clique.optimum(dense) == _brute_clique(dense)


def test_certificates_catch_broken_answers():
    dense = instances.gnp(40, 4.0, 1)
    cover = bits.pack(torch.ones(64, dtype=torch.bool)[None])[0].numpy().view(np.uint32).copy()
    cover[1] = 0xFF  # vertices 0..39 in, 40..63 out
    assert vertex_cover.infeasible(dense, 40, cover) is False
    assert vertex_cover.infeasible(dense, 39, cover)  # wrong size
    u, v = map(int, np.argwhere(np.triu(dense, 1))[0])
    broken = cover.copy()
    for x in (u, v):
        broken[x // 32] &= ~np.uint32(1 << (x % 32))
    assert vertex_cover.infeasible(dense, 38, broken)  # an edge uncovered
    clique = np.zeros(2, np.uint32)
    clique[u // 32] |= np.uint32(1 << (u % 32))
    clique[v // 32] |= np.uint32(1 << (v % 32))
    assert max_clique.infeasible(dense, 2, clique) is False
    assert max_clique.infeasible(dense, 3, clique)
    far = next(w for w in range(40) if not dense[u, w] and w != u)
    clique[far // 32] |= np.uint32(1 << (far % 32))
    assert max_clique.infeasible(dense, 3, clique)
    from perfbench.bench import find

    judge = find(ROOT, "judges", "branch_and_bound")
    one = {"pool": 0, "size": 1, "words": np.array([1, 0], np.uint32), "exact": True}
    assert judge._answers(max_clique, {"guarantees": {"optimum_checked": True}},
                          {"answers": [one], "pool": [dense]}) == (0, 1)
