"""The port's copy of the serving balancer (``repro_torch.serving.balancer``):
each case of ``tests/test_balancer.py`` on the port, and ``simulate`` /
``rebalance`` held against the JAX package's module on the same seeded
traces (makespan, idle slot steps, transfers, control ints and the replicas'
queues after each round, exactly)."""

import copy

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro.serving import balancer as jax_balancer
from repro_torch.serving.balancer import (
    BalancerState,
    RequestBatch,
    SolveBatcher,
    rebalance,
    simulate,
    solve_stream,
)


class _FakeGraph:
    """Just enough of a BitGraph for the admission logic (n, W)."""

    def __init__(self, n):
        self.n = n
        self.W = (n + 31) // 32


def test_rebalance_moves_heaviest_to_neediest():
    reps = [RequestBatch(4, [], [10, 99, 5]), RequestBatch(4, [], [])]
    state = BalancerState(reps)
    assert rebalance(state) == 1
    assert 99 in reps[1].queued_work


def test_failure_free_matching():
    reps = [RequestBatch(4, [1], []), RequestBatch(4, [], [])]
    assert rebalance(BalancerState(reps)) == 0


@settings(max_examples=30, deadline=None)
@given(
    st.lists(st.integers(1, 64), min_size=4, max_size=60),
    st.integers(2, 8),
)
def test_work_conservation(works, replicas):
    reps = [RequestBatch(4, [], []) for _ in range(replicas)]
    reps[0].queued_work = list(works)
    state = BalancerState(reps)
    for _ in range(5):
        rebalance(state)
        total = sorted(w for r in reps for w in (r.active_work + r.queued_work))
        assert total == sorted(works)


def test_solve_batcher_buckets_and_fills():
    b = SolveBatcher(batch_size=2)
    tickets = [b.submit(_FakeGraph(n)) for n in (20, 40, 22, 44, 24)]
    batches = b.ready_batches()
    assert [sorted(g.n for g in b.take(batch)) for batch in batches] == [
        [22, 24],
        [40, 44],
    ]
    rest = b.flush()
    assert [[g.n for g in b.take(batch)] for batch in rest] == [[20]]
    assert sorted(s for batch in batches + rest for s in batch) == tickets
    assert b.graphs == {}


def test_batcher_status_surfaces_vacant_lanes_of_partial_buckets():
    b = SolveBatcher(batch_size=4)
    for n in (20, 22, 24):
        b.submit(_FakeGraph(n))
    assert b.status() == {("vertex_cover", 1): {"queued": 3, "admitted": 0, "vacant": 4}}
    batches = b.flush()
    assert [len(batch) for batch in batches] == [3]
    assert b.status() == {("vertex_cover", 1): {"queued": 0, "admitted": 0, "vacant": 4}}
    assert sorted(g.n for g in b.take(batches[0])) == [20, 22, 24]


def test_batcher_take_rejects_undrained_tickets():
    b = SolveBatcher(batch_size=2)
    t1 = b.submit(_FakeGraph(20))
    with pytest.raises(ValueError, match=f"{t1}"):
        b.take([t1])
    t2 = b.submit(_FakeGraph(22))
    (batch,) = b.ready_batches()
    with pytest.raises(ValueError, match="not in any drained batch"):
        b.take([t1, t2, 99])
    assert sorted(g.n for g in b.take(batch)) == [20, 22]
    with pytest.raises(ValueError):
        b.take(batch)


def test_solve_stream_returns_submission_order():
    gs = [_FakeGraph(n) for n in (20, 40, 22, 24, 44, 26, 28)]
    seen = []

    def fake_solver(batch, **kw):
        assert len({g.W for g in batch}) == 1
        seen.append([g.n for g in batch])
        return [g.n * 100 for g in batch]

    assert solve_stream(gs, 2, solver=fake_solver) == [g.n * 100 for g in gs]
    assert all(len(batch) <= 2 for batch in seen)


def test_buckets_key_on_problem_and_width():
    b = SolveBatcher(batch_size=2)
    t_vc = [b.submit(_FakeGraph(n), "vertex_cover") for n in (20, 22)]
    t_cl = [b.submit(_FakeGraph(n), "max_clique") for n in (21, 23)]
    batches = b.ready_batches()
    assert len(batches) == 2
    assert sorted(b.problem_of(batch[0]) for batch in batches) == [
        "max_clique", "vertex_cover"]
    for batch in batches:
        assert len({b.problem_of(t) for t in batch}) == 1
    assert sorted(t for batch in batches for t in batch) == sorted(t_vc + t_cl)


def test_solve_stream_mixed_problems():
    gs = [_FakeGraph(n) for n in (20, 21, 22, 23)]
    probs = ["vertex_cover", "mis", "vertex_cover", "mis"]
    calls = []

    def fake_solver(batch, problem=None, **kw):
        calls.append((problem, [g.n for g in batch]))
        return [f"{problem}:{g.n}" for g in batch]

    out = solve_stream(gs, 2, solver=fake_solver, problem=probs)
    assert out == [f"{p}:{g.n}" for p, g in zip(probs, gs)]
    assert sorted(p for p, _ in calls) == ["mis", "vertex_cover"]


def test_balancing_reduces_makespan():
    works = list(np.random.default_rng(0).integers(8, 128, 48))
    off = simulate(8, 4, works, balance=False)
    on = simulate(8, 4, works, balance=True)
    assert on["rounds"] < off["rounds"]
    assert on["idle_slot_steps"] < off["idle_slot_steps"]
    assert on["control_ints_per_round"] == 16


def test_solve_stream_unknown_option_lists_known():
    with pytest.raises(ValueError, match="unknown solve_stream option"):
        solve_stream([_FakeGraph(10)], 2, device="cpu", bogus=1)


# -- parity with the JAX package's module ---------------------------------------


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_simulate_matches_jax(seed, balance):
    rng = np.random.default_rng(seed)
    replicas, capacity = int(rng.integers(2, 9)), int(rng.integers(1, 6))
    works = [int(w) for w in rng.integers(1, 96, int(rng.integers(4, 80)))]
    got = simulate(replicas, capacity, works, balance=balance, seed=seed)
    want = jax_balancer.simulate(replicas, capacity, works, balance=balance, seed=seed)
    assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_matches_jax(seed):
    """Random replica states, rebalanced round after round with admission
    and decoding between rounds: every round moves the same requests."""
    rng = np.random.default_rng(seed)
    reps = [
        RequestBatch(
            int(rng.integers(1, 6)),
            [int(w) for w in rng.integers(1, 40, int(rng.integers(0, 4)))],
            [int(w) for w in rng.integers(1, 40, int(rng.integers(0, 12)))],
        )
        for _ in range(int(rng.integers(2, 7)))
    ]
    low_water = float(rng.choice([0.25, 0.5, 0.75, 1.0]))
    mine = BalancerState(reps, low_water=low_water)
    theirs = jax_balancer.BalancerState(
        [jax_balancer.RequestBatch(r.capacity, list(r.active_work), list(r.queued_work))
         for r in copy.deepcopy(reps)],
        low_water=low_water,
    )
    for _ in range(8):
        assert (mine.status() == theirs.status()).all()
        assert rebalance(mine) == jax_balancer.rebalance(theirs)
        for a, b in zip(mine.replicas, theirs.replicas):
            a.admit()
            b.admit()
            assert a.step(2) == b.step(2)
            assert (a.active_work, a.queued_work) == (b.active_work, b.queued_work)
    assert (mine.transfers, mine.control_ints_per_round) == (
        theirs.transfers, theirs.control_ints_per_round)
