"""The batched plane of the port (``SolverSession.solve_many``) against the
JAX package and against the port's own solo solves, on the CPU.

* the ``many`` golden of ``tests/golden_vc.json`` (padding, bucketing),
  bit for bit, and the JAX ``solve_many`` result field for field (results,
  buckets, compactions, lane occupancy) on vertex cover, max clique and MIS;
* batch == singles, mixed-W bucket order, compaction, the basic codec's
  exact-n buckets and per-instance FPT bounds (``tests/test_solve_many.py``);
* the center works per instance: donation never crosses the instance axis
  and quiescence is per instance, on a hand-built batch, in step with the
  JAX batch superstep;
* ``clique_smoke``'s configuration gives ``[4, 6, 4, 4]``;
* a JAX batch runs k chunks, its ``LaneState`` goes through the flat layout
  into the port, and both finish in lockstep with equal states.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import assert_flat_equal

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.core import engine as jax_engine
from repro.core import superstep as jss
from repro.core.frontier import Frontier as JaxFrontier
from repro.graphs.generators import erdos_renyi
from repro.problems import base as jb
from repro.problems.registry import get_problem
from repro_torch.api import SolveConfig, SolverSession
from repro_torch.core import engine as torch_engine
from repro_torch.core import superstep as tss
from repro_torch.problems import base as tb
from repro_torch.problems.registry import get_problem as get_torch_problem
from repro_torch.problems.sequential import solve_sequential, solve_sequential_max_clique

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_vc.json").read_text())

FIELDS = ("best_size", "rounds", "nodes_expanded", "tasks_transferred", "found")
STATS = ("overflow", "overflow_count", "control_bytes_per_round",
         "transfer_rounds", "transfer_bytes_total", "transfer_bytes_per_round")
LANE_STATS = ("chunk_calls", "lane_chunks", "live_lane_chunks", "occupancy")


def _record(r) -> dict:
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


def _same_result(want, got):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    if want.best_sol is None:
        assert got.best_sol is None
    else:
        assert (np.asarray(got.best_sol) == np.asarray(want.best_sol)).all()
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name


def _both_many(graphs, problem="vertex_cover", **kw):
    """The JAX and the port ``solve_many`` of the same batch, compared."""
    jb_ = JaxSession(problem=problem, config=JaxConfig(**kw)).solve_many(graphs)
    tb_ = SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu").solve_many(graphs)
    assert len(tb_) == len(graphs)
    for want, got in zip(jb_.results, tb_.results):
        _same_result(want, got)
    assert [list(b) for b in tb_.buckets] == [list(b) for b in jb_.buckets]
    assert tb_.compactions == jb_.compactions
    for name in LANE_STATS:
        assert getattr(tb_.lane_stats, name) == getattr(jb_.lane_stats, name), name
    return tb_


def _assert_matches_solo(graphs, batch, problem="vertex_cover", **kw):
    session = SolverSession(problem=problem, config=SolveConfig(**kw), device="cpu")
    for g, b in zip(graphs, batch.results):
        _same_result(session.solve(g), b)
        assert not b.stats.overflow


def test_many_golden():
    case = GOLDEN["many"]
    graphs = [
        erdos_renyi(n, case["p"], case["seed0"] + i)
        for i, n in enumerate(case["sizes"])
    ]
    batch = SolverSession(config=SolveConfig(**case["solve_kw"]), device="cpu").solve_many(graphs)
    assert batch.compactions == case["compactions"]
    assert [[W, n_max, idxs] for W, n_max, idxs in batch.buckets] == case["buckets"]
    assert [_record(r) for r in batch.results] == case["results"]
    assert batch.lane_stats.reduce_sweeps > 0


@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_batch_matches_singles_and_jax(seed):
    """Mixed sizes padded onto one plane: equal to B solo solves and to the
    JAX batch, and optimal."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(10, 27, size=3)
    graphs = [erdos_renyi(int(n), 0.3, int(s)) for n, s in zip(sizes, rng.integers(0, 1000, size=3))]
    kw = dict(num_workers=4, steps_per_round=4)
    batch = _both_many(graphs, **kw)
    _assert_matches_solo(graphs, batch, **kw)
    for g, b in zip(graphs, batch.results):
        assert b.best_size == solve_sequential(g)[0]


@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_clique_and_mis_batches_match_singles_and_jax(problem):
    graphs = [erdos_renyi(n, 0.35, 30 + n) for n in (14, 22, 31, 40)]  # W 1 and 2
    kw = dict(num_workers=4, steps_per_round=4, lanes=2, donate_k=2, chunk_rounds=3)
    batch = _both_many(graphs, problem, **kw)
    _assert_matches_solo(graphs, batch, problem, **kw)


def test_mixed_word_buckets_preserve_order():
    graphs = [
        erdos_renyi(40, 0.28, 0),  # W=2
        erdos_renyi(20, 0.3, 1),  # W=1
        erdos_renyi(36, 0.28, 2),  # W=2 (padded to 40 in its bucket)
        erdos_renyi(14, 0.3, 3),  # W=1 (padded to 20)
    ]
    kw = dict(num_workers=4, steps_per_round=8)
    batch = _both_many(graphs, **kw)
    assert [(W, n_max, idxs) for W, n_max, idxs in batch.buckets] == [
        (1, 20, [1, 3]), (2, 40, [0, 2])
    ]
    _assert_matches_solo(graphs, batch, **kw)


def test_compaction_bit_identical():
    graphs = [erdos_renyi(12, 0.3, s) for s in range(6)] + [
        erdos_renyi(30, 0.25, 0),
        erdos_renyi(30, 0.28, 6),
    ]
    kw = dict(num_workers=4, steps_per_round=1, chunk_rounds=1)
    batch = _both_many(graphs, compact_threshold=0.5, **kw)
    assert batch.compactions > 0
    _assert_matches_solo(graphs, batch, **kw)


def test_basic_codec_buckets_by_exact_n():
    graphs = [erdos_renyi(24, 0.3, 1), erdos_renyi(20, 0.3, 2)]
    kw = dict(num_workers=4, steps_per_round=4, codec="basic")
    batch = _both_many(graphs, **kw)
    assert len(batch.buckets) == 2  # same W, different n
    _assert_matches_solo(graphs, batch, **kw)


def test_fpt_mode_per_instance_bounds():
    graphs = [erdos_renyi(24, 0.3, 1), erdos_renyi(20, 0.3, 2)]
    opts = [solve_sequential(g)[0] for g in graphs]
    ks = (opts[0], opts[1] - 1)  # the first solvable at its optimum, the second not
    batch = _both_many(graphs, num_workers=4, mode="fpt", k=ks)
    assert batch.results[0].best_size != -1
    assert batch.results[0].best_size <= opts[0]
    assert batch.results[1].best_size == -1 and batch.results[1].best_sol is None


def test_clique_smoke_sizes():
    """benchmarks/clique_smoke.py's smoke configuration through the port."""
    graphs = [erdos_renyi(20, 0.4, seed) for seed in range(4)]
    session = SolverSession(problem="max_clique", config=SolveConfig(num_workers=4, steps_per_round=8),
                            device="cpu")
    batch = session.solve_many(graphs)
    assert [r.best_size for r in batch.results] == [4, 6, 4, 4]
    for g, r in zip(graphs, batch.results):
        assert r.best_size == solve_sequential_max_clique(g)[0]


def test_cache_accounting_matches_jax():
    """The same calls give the JAX package's hit/miss/plane/shape counts."""
    graphs = [erdos_renyi(20, 0.4, s) for s in range(3)]
    kw = dict(num_workers=4, steps_per_round=8)
    js = JaxSession(problem="max_clique", config=JaxConfig(**kw))
    ts = SolverSession(problem="max_clique", config=SolveConfig(**kw), device="cpu")
    for session in (js, ts):
        session.solve_many(graphs)
        session.solve_many(graphs)
        session.solve(graphs[0])
        session.solve(graphs[1])
    keys = ("hits", "misses", "planes", "shapes")
    assert {k: ts.cache_stats()[k] for k in keys} == {k: js.cache_stats()[k] for k in keys}
    assert ts.cache_stats()["hits"] == 2


# -- the center per instance: a hand-built batch --------------------------------


def _hand_built_batch(masks_spec, P=4, cap=8, W=1):
    """A (B, P, cap) JAX worker state with explicit frontier contents, as
    its flat dict.  masks_spec[b] = list of (worker, mask, depth)."""
    B = len(masks_spec)
    masks = np.zeros((B, P, cap, W), np.uint32)
    depths = np.zeros((B, P, cap), np.int32)
    active = np.zeros((B, P, cap), bool)
    slot = np.zeros((B, P), np.int64)
    for b, spec in enumerate(masks_spec):
        for w, mask, depth in spec:
            s = slot[b, w]
            masks[b, w, s, 0] = mask
            depths[b, w, s] = depth
            active[b, w, s] = True
            slot[b, w] += 1
    z = jnp.zeros((B, P), jnp.int32)
    return jss.WorkerState(
        frontier=JaxFrontier(
            masks=jnp.asarray(masks), sols=jnp.zeros((B, P, cap, W), jnp.uint32),
            depths=jnp.asarray(depths), active=jnp.asarray(active),
            overflow=jnp.zeros((B, P), bool), dropped=z,
        ),
        best_val=jnp.full((B, P), 99, jnp.int32),
        local_best_val=jnp.full((B, P), 99, jnp.int32),
        best_sol=jnp.zeros((B, P, W), jnp.uint32),
        nodes_expanded=z, tasks_sent=z, tasks_recv=z, rounds=z,
        transfer_rounds=z, payload_words=z,
    )


def _one_batch_superstep(masks_spec, n=16):
    """One superstep without exploration on both packages; returns the
    port's (state (B, P, ...), done) after checking it equals the JAX one."""
    state = _hand_built_batch(masks_spec)
    B, P = state.best_val.shape
    W = state.best_sol.shape[-1]
    v = np.arange(n, dtype=np.int32)
    jdata = jb.ProblemData(
        n=jnp.full((B,), n, jnp.int32), adj=jnp.zeros((B, n, W), jnp.uint32),
        word_idx=jnp.asarray(v // 32), bit_idx=jnp.asarray((v % 32).astype(np.uint32)),
    )
    fn = jss.build_batch_superstep_fn(get_problem("vertex_cover"), jdata,
                                      steps_per_round=0, lanes=1, explore_impl="fused")
    jnew, jdone = fn(state)
    flat = tss.worker_state_from_flat(jss.worker_state_to_flat(state), "cpu")
    tdata = tb.ProblemData(n=np.full(B, n, np.int32), adj=tb.make_data(
        get_torch_problem("vertex_cover"), erdos_renyi(n, 0.0, 0), "cpu").adj.expand(B, n, W))
    tnew, tdone = tss.superstep(
        get_torch_problem("vertex_cover"), tdata,
        tss.map_state(lambda x: x.reshape(B * P, *x.shape[2:]), flat),
        steps_per_round=0, lanes=1,
    )
    tnew = tss.map_state(lambda x: x.reshape(B, P, *x.shape[1:]), tnew)
    assert_flat_equal(jss.worker_state_to_flat(jnew), tss.worker_state_to_flat(tnew))
    assert tdone.tolist() == np.asarray(jdone).tolist()
    return tss.worker_state_to_flat(tnew), tdone.tolist()


def test_donation_never_crosses_instance_axis():
    """Instance 0 has idle workers but no donor; instance 1 has a donor.
    Instance 0 receives nothing though instance 1's donor has spare tasks."""
    flat, done = _one_batch_superstep([
        [(0, 0xAAAA, 5)],  # pending=1: neither idle nor donor; workers 1-3 idle
        [(0, 0x1, 3), (0, 0x3, 2), (0, 0x7, 1)],  # worker 0 donates 0x7 (depth 1)
    ])
    assert done == [False, False]
    assert flat["worker.tasks_recv"][0].sum() == 0 and flat["worker.tasks_sent"][0].sum() == 0
    act = flat["worker.frontier.active"]
    masks = flat["worker.frontier.masks"][..., 0]
    assert act[0].sum() == 1 and set(masks[0][act[0]].tolist()) == {0xAAAA}
    assert flat["worker.tasks_sent"][1].sum() == 1 and flat["worker.tasks_recv"][1].sum() == 1
    assert sorted(masks[1][act[1]].tolist()) == [0x1, 0x3, 0x7]  # moved, not copied
    recv = int(flat["worker.tasks_recv"][1].argmax())
    assert recv != 0 and masks[1, recv][act[1, recv]].tolist() == [0x7]


def test_per_instance_quiescence():
    _, done = _one_batch_superstep([[], [(0, 0x1, 0), (1, 0x3, 1)]])
    assert done == [True, False]


# -- a JAX batch carried into the port ------------------------------------------


@pytest.mark.parametrize("problem,chunks", [("vertex_cover", 2), ("max_clique", 1), ("mis", 1)])
def test_lane_state_carried_from_jax(problem, chunks):
    graphs = [erdos_renyi(n, 0.3, 80 + n) for n in (26, 31, 19)]
    n_max, W, P = 31, 1, 4
    cap = 4 * n_max + 8
    jspec, tspec = get_problem(problem), get_torch_problem(problem)
    knobs = dict(steps_per_round=2, lanes=1, chunk_rounds=2, donate_k=2)
    bests = [jb.initial_bound(jspec, g, "bnb", None) for g in graphs]
    lanes = jss.LaneState(
        worker=jax_engine._make_batch_state(jspec, graphs, P, cap, W, bests),
        done=jnp.zeros((3,), bool), tag=np.arange(3, dtype=np.int32),
        rounds=jnp.zeros((3,), jnp.int32),
    )
    jdatas = jb.make_batch_data(jspec, graphs, n_max, W)
    jplane = jss.build_batch_plane_fn(jspec, explore_impl="fused", **knobs)
    for _ in range(chunks):
        lanes, _, _ = jss.step_lanes(jplane, jdatas, lanes)
    flat = jss.lane_state_to_flat(lanes)
    assert not np.asarray(lanes.done).all()

    tlanes = tss.lane_state_from_flat(flat, "cpu")
    assert_flat_equal(flat, tss.lane_state_to_flat(tlanes))
    tdatas = tb.make_batch_data(tspec, graphs, n_max, W, "cpu")
    tplane = tss.build_batch_plane_fn(tspec, **knobs)
    while not np.asarray(lanes.done).all():  # both finish in lockstep
        lanes, jran, jhot = jss.step_lanes(jplane, jdatas, lanes)
        tlanes, tran, thot = tss.step_lanes(tplane, tdatas, tlanes)
        assert tran == int(jran) and (thot.numpy() == np.asarray(jhot)).all()
        assert_flat_equal(jss.lane_state_to_flat(lanes), tss.lane_state_to_flat(tlanes))
    # and the port's result extraction reads the JAX package's results
    jhost = jax_engine._fetch_batch_state(lanes.worker)
    thost = torch_engine._fetch_batch_state(tlanes.worker)
    rounds = np.asarray(lanes.rounds)
    for lane, g in enumerate(graphs):
        args = (g, int(rounds[lane]), 0.0)
        kw = dict(mode="bnb", k=None, num_workers=P, packed_status=True)
        want = jax_engine._extract_result(jhost, lane, jspec, *args, **kw)
        got = torch_engine._extract_result(thost, lane, tspec, *args, **kw)
        assert got.best_size == want.best_size and (got.best_sol == want.best_sol).all()
        assert (got.nodes_expanded, got.tasks_transferred) == (want.nodes_expanded, want.tasks_transferred)
