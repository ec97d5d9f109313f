"""The general generator of the instances a traffic mix sends.

A configuration names a graph family and its size; a traffic mix names a
pool: ``pool`` instances drawn once from ``pool_seed``, the same for every
run, and ``clients`` streams of requests over it: stream i sends the pool's
instances in turn from position ``i · pool / clients`` on.  ``--seed`` only
orders the streams: it permutes the order in which they submit, and so the
lanes their requests land in.  So every seed sends the same requests in
another order: instances of one family differ in their work, and a seed
that chose which ones a window sees would change the work it measures.

The families: G(n, p) with p = avg_degree / (n - 1), the paper's random
family (§4.4.1), copied from the port's generator; and the p_hat generator
of the 2nd DIMACS Challenge's clique graphs (Gendreau, Soriano and Salvail,
1993), written from its definition: each vertex draws its own density
p_v uniformly from [a, b], and edge uv is present with probability
``(p_u + p_v) / 2``.
"""

from __future__ import annotations

import numpy as np


def _seed_words(seed: int) -> int:
    return int(seed) % 2**64


def gnp(n: int, avg_degree: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < avg_degree / (n - 1), 1)
    return upper | upper.T


def p_hat(n: int, a: float, b: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.uniform(a, b, n)
    prob = (p[:, None] + p[None, :]) / 2
    upper = np.triu(rng.random((n, n)) < prob, 1)
    return upper | upper.T


FAMILIES = {
    "gnp": lambda g, seed: gnp(g["n"], g["avg_degree"], seed),
    "p_hat": lambda g, seed: p_hat(g["n"], g["a"], g["b"], seed),
}


def pool(graph: dict, pool_seed: int, size: int) -> list:
    """The pool's dense adjacency matrices; instance i is drawn from the
    i-th word of ``SeedSequence(pool_seed)``."""
    words = np.random.SeedSequence(_seed_words(pool_seed)).generate_state(size, np.uint64)
    make = FAMILIES[graph["family"]]
    return [make(graph, int(w)) for w in words]


def stream(i: int, k: int, clients: int, size: int) -> int:
    """The pool index of stream i's k-th request."""
    return (i * size // clients + k) % size


def order(seed: int, size: int) -> np.ndarray:
    """The run's permutation of ``size`` streams."""
    return np.random.default_rng(np.random.SeedSequence(_seed_words(seed))).permutation(size)


def rng(seed: int, purpose: int) -> np.random.Generator:
    """A generator for the run's other draws (which launches and lanes the
    check samples), apart from the order."""
    return np.random.default_rng(np.random.SeedSequence([_seed_words(seed), purpose]))
