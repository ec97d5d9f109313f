"""The generator: the same seed gives the same requests, every seed the
same requests in another order, and seeds past 32 bits work."""

import numpy as np
import pytest

from perfbench import instances

GRAPHS = [{"family": "gnp", "n": 50, "avg_degree": 4.0},
          {"family": "p_hat", "n": 40, "a": 0.0, "b": 0.5}]


@pytest.mark.parametrize("graph", GRAPHS)
def test_pool_is_fixed_and_symmetric(graph):
    a, b = instances.pool(graph, 7, 5), instances.pool(graph, 7, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    for g in a:
        assert g.shape == (graph["n"],) * 2 and (g == g.T).all() and not g.diagonal().any()


@pytest.mark.parametrize("seed", [0, 12, 2**31 + 3, 3 * 2**31 + 1, 2**63 + 5])
def test_order_is_a_permutation_fixed_by_the_seed(seed):
    o = instances.order(seed, 64)
    assert sorted(o.tolist()) == list(range(64))
    assert np.array_equal(o, instances.order(seed, 64))
    assert not np.array_equal(o, instances.order(seed + 1, 64))
    assert instances.rng(seed, 1).integers(1 << 30) == instances.rng(seed, 1).integers(1 << 30)


def test_gnp_matches_the_port_generator():
    from repro_torch.graphs.generators import erdos_renyi

    assert np.array_equal(instances.gnp(60, 4.0, 3), erdos_renyi(60, 4.0 / 59, 3).to_dense())


def test_p_hat_follows_its_definition():
    # p_v ~ U(a, b), edge uv with probability (p_u + p_v) / 2: the -1 pair
    # gives density 0.25, and each vertex's degree follows its own p
    n, a, b = 300, 0.0, 0.5
    dens = []
    for seed in range(4):
        g = instances.p_hat(n, a, b, seed)
        p = np.random.default_rng(seed).uniform(a, b, n)
        expected = ((p[:, None] + p[None, :]) / 2).sum(1) - p
        assert np.corrcoef(g.sum(1), expected)[0, 1] > 0.9
        dens.append(g.sum() / (n * (n - 1)))
    assert abs(np.mean(dens) - 0.25) < 0.01


@pytest.mark.parametrize("clients,size", [(32, 32), (64, 64), (8, 20)])
def test_streams_walk_the_pool_from_spread_offsets(clients, size):
    first = [instances.stream(i, 0, clients, size) for i in range(clients)]
    assert len(set(first)) == min(clients, size)
    for i in range(clients):
        seq = [instances.stream(i, k, clients, size) for k in range(size)]
        assert sorted(seq) == list(range(size)) and seq[0] == first[i]
