"""Graph generators and DIMACS I/O.

The paper benchmarks on DIMACS challenge graphs (p_hat1000-2, p_hat700-1,
DSJ500.5) and on 100 G(n,p) random graphs with expected degree 4 (§4.4.1).
We reproduce the G(n,p) family exactly and provide a ``p_hat_like`` generator
(the p_hat family is G(n,p) with non-uniform, vertex-weighted edge densities,
giving the skewed degree distribution that makes those instances hard).
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.bitgraph import BitGraph


def erdos_renyi(n: int, p: float, seed: int) -> BitGraph:
    """G(n, p): each of the C(n,2) edges present independently w.p. ``p``.

    The paper's random family is n=600, p=4/(n-1) (expected degree 4).
    """
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    dense = np.triu(upper, 1)
    return BitGraph.from_dense(dense | dense.T)


def p_hat_like(n: int, density: float, seed: int, spread: float = 2.0) -> BitGraph:
    """p_hat-style graph: vertex weights w_v ~ U(0,1)^spread, edge uv present
    w.p. clip(density * (w_u + w_v), 0, 1).  Produces the wide degree spread
    characteristic of the DIMACS p_hat instances (p_hat700-1 ~ density .25,
    p_hat1000-2 ~ density .5)."""
    rng = np.random.default_rng(seed)
    w = rng.random(n) ** spread
    prob = np.clip(density * (w[:, None] + w[None, :]), 0.0, 1.0)
    dense = np.triu(rng.random((n, n)) < prob, 1)
    return BitGraph.from_dense(dense | dense.T)


def parse_dimacs(text: str) -> BitGraph:
    """Parse DIMACS ``.clq``/``.col`` edge format ('p edge N M' + 'e u v')."""
    n = 0
    edges = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("c"):
            continue
        parts = line.split()
        if parts[0] == "p":
            n = int(parts[2])
        elif parts[0] == "e":
            u, v = int(parts[1]) - 1, int(parts[2]) - 1
            edges.append((u, v))
    return BitGraph.from_edges(n, edges)


def to_dimacs(g: BitGraph) -> str:
    edges = g.edges()
    lines = [f"p edge {g.n} {len(edges)}"]
    lines += [f"e {u + 1} {v + 1}" for u, v in edges]
    return "\n".join(lines) + "\n"
