"""The port's hierarchical frontier memory against the JAX package's.

``repro_torch.core.spill`` holds its own copy of ``repro/core/spill.py``;
its pump is host numpy, so every comparison here is exact:

* ``chunk_headroom`` and ``resolve_watermarks`` over a grid, the error text
  included;
* ``pump_host`` on seeded random pools (the ``_full_pool`` shape of
  ``tests/test_spill.py``) leaves the same arrays, counters and
  byte-identical ``to_flat`` arrays as JAX's, through spill and drain
  cycles, and each package's ``load_flat`` reads the other's arrays;
* the device boundary (``read_pool``/``write_pool`` and their lane forms)
  round-trips int32 words as uint32 bits and leaves ``overflow``/``dropped``
  alone;
* whole spilled solves equal JAX field for field, the spill counters
  included: solo vertex cover on the saturating ``_SAT`` shape of
  ``tests/test_spill.py`` with both codecs (best 29, 21 rounds, 8 spilled
  and readmitted, a cold peak of 60 and 1,020 bytes), FPT with k = 29 and
  k = 20, max clique and MIS, ``solve_many`` of ``tests/test_spill.py``'s
  four instances across one compaction, and a 2-lane service of 3 tickets
  step by step under a shared fake clock;
* an undersized capacity raises at solve start in both packages.
"""

import numpy as np
import pytest
import torch

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.api import SolveService as JaxService
from repro.core import encoding as jax_enc
from repro.core import spill as jax_spill
from repro.graphs import generators as jax_gen
from repro_torch.api import SolveConfig, SolverSession, SolveService
from repro_torch.core import encoding as enc
from repro_torch.core import spill
from repro_torch.core.frontier import (
    Frontier,
    read_lane_pool,
    read_pool,
    write_lane_pool,
    write_pool,
)
from repro_torch.graphs import generators
from repro_torch.problems.sequential import verify_cover

from tests._torch_parity import t32

CPU = dict(device="cpu")
# tests/test_spill.py's saturating shape: n = 40 VC with hot peaks ~15 per
# worker at capacity 16 and a one-chunk headroom of 7
_SAT = dict(num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=16)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fields(r) -> dict:
    s = r.stats
    return {
        "best_size": int(r.best_size),
        "best_sol": (None if r.best_sol is None
                     else [int(w) for w in np.asarray(r.best_sol, np.uint32)]),
        "found": bool(r.found),
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(s.transfer_rounds),
        "transfer_bytes_total": int(s.transfer_bytes_total),
        "overflow": bool(s.overflow),
        "overflow_count": int(s.overflow_count),
        "spilled_tasks": int(s.spilled_tasks),
        "readmitted_tasks": int(s.readmitted_tasks),
        "cold_bytes_peak": int(s.cold_bytes_peak),
    }


# -- 1. watermark resolution ---------------------------------------------------


_GRID = [
    (cap, wm, cr, spr, lanes, dk)
    for cap in (2, 8, 16, 64, 2408)
    for wm in ((0.5, 0.9), (0.25, 0.75), (0.05, 0.1))
    for cr in (1, 2, 16)
    for spr, lanes, dk in ((2, 1, 1), (32, 1, 1), (4, 2, 3))
]


def test_watermarks_equal_jax_over_a_grid():
    for cap, wm, cr, spr, lanes, dk in _GRID:
        kw = dict(chunk_rounds=cr, steps_per_round=spr, lanes=lanes, donate_k=dk)
        assert spill.chunk_headroom(**kw) == jax_spill.chunk_headroom(**kw)
        try:
            want = jax_spill.resolve_watermarks(cap, wm, **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                spill.resolve_watermarks(cap, wm, **kw)
            assert str(got.value) == str(e)
        else:
            assert spill.resolve_watermarks(cap, wm, **kw) == want
    assert spill.BAND_WIDTH == jax_spill.BAND_WIDTH
    assert spill.chunk_headroom(chunk_rounds=16, steps_per_round=32, lanes=1,
                                donate_k=1) == 529


# -- 2. the host pump ------------------------------------------------------------


def _spillers(seed, wm, codec="optimized", n=40, P=4, cap=32):
    kw = dict(chunk_rounds=1, steps_per_round=2, lanes=1, donate_k=1)
    g, jg = generators.erdos_renyi(n, 0.3, seed), jax_gen.erdos_renyi(n, 0.3, seed)
    ours = spill.FrontierSpiller(enc.make_codec(codec, n), P, cap, wm, graph=g, **kw)
    theirs = jax_spill.FrontierSpiller(jax_enc.make_codec(codec, n), P, cap, wm,
                                       graph=jg, **kw)
    return ours, theirs


def _random_pool(rng, P, cap, W, fill):
    """(P, CAP, ...) host pool: ``fill[w]`` active tasks at random slots of
    worker w, random words and depths over several bands."""
    masks = rng.integers(0, 2**32, size=(P, cap, W), dtype=np.uint32)
    sols = rng.integers(0, 2**32, size=(P, cap, W), dtype=np.uint32)
    depths = rng.integers(0, 40, size=(P, cap)).astype(np.int32)
    active = np.zeros((P, cap), bool)
    for w in range(P):
        active[w, rng.choice(cap, size=fill[w], replace=False)] = True
    return masks, sols, depths, active


def _same_state(ours, theirs):
    assert (ours.spilled_total, ours.readmitted_total, ours.cold_tasks,
            ours.cold_bytes_peak) == (theirs.spilled_total, theirs.readmitted_total,
                                      theirs.cold_tasks, theirs.cold_bytes_peak)
    a, b = ours.to_flat("s"), theirs.to_flat("s")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,wm,codec", [
    (0, (0.25, 0.75), "optimized"),
    (1, (0.5, 0.9), "optimized"),
    (2, (0.1, 0.5), "optimized"),
    (3, (0.25, 0.75), "basic"),
])
def test_pump_host_equals_jax(seed, wm, codec):
    rng = np.random.default_rng(seed)
    P, cap, n = 4, 32, 40
    ours, theirs = _spillers(seed, wm, codec, n=n, P=P, cap=cap)
    assert (ours.low, ours.high, ours.order) == (theirs.low, theirs.high, theirs.order)
    W = ours.codec.W
    # spill cycles from full pools, then drain cycles from sparse pools
    for cycle in range(6):
        hi = cap if cycle < 3 else ours.low
        pool = _random_pool(rng, P, cap, W, rng.integers(0, hi + 1, size=P))
        mine = tuple(x.copy() for x in pool)
        assert ours.wants_pump(mine[3].sum(1), cycle == 5) == \
            theirs.wants_pump(pool[3].sum(1), cycle == 5)
        assert ours.pump_host(*mine) == theirs.pump_host(*pool)
        for x, y in zip(mine, pool):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        _same_state(ours, theirs)
    assert ours.spilled_total > 0 and ours.readmitted_total > 0


def test_flat_arrays_cross_packages():
    """Each package's ``load_flat`` reads the other's ``to_flat`` (zero-row
    blocks and int64 counters too), and bare pre-checksum records upgrade."""
    rng = np.random.default_rng(7)
    ours, theirs = _spillers(7, (0.25, 0.75))
    pool = _random_pool(rng, 4, 32, ours.codec.W, [32, 30, 3, 0])
    theirs.pump_host(*pool)
    flat = theirs.to_flat("spill3")
    assert any(v.shape[0] == 0 for k, v in flat.items() if ".w" in k)
    assert flat["spill3.counters"].dtype == np.int64
    back, _ = _spillers(7, (0.25, 0.75))
    back.load_flat(flat, "spill3")
    _same_state(back, theirs)
    again, jagain = _spillers(7, (0.25, 0.75))
    jagain.load_flat(back.to_flat("spill3"), "spill3")
    _same_state(back, jagain)
    # legacy bare blocks: the trailing CRC32 word is dropped, then restored
    bare = {k: (v[:, :-1] if ".w" in k else v) for k, v in flat.items()}
    again.load_flat(bare, "spill3")
    _same_state(again, theirs)
    # a rotten record refuses to load in both packages
    k = next(k for k, v in flat.items() if ".w" in k and v.shape[0])
    rotten = dict(flat)
    rotten[k] = flat[k].copy()
    rotten[k][0, 0] ^= np.uint32(1)
    with pytest.raises(enc.PayloadCorruptionError):
        again.load_flat(rotten, "spill3")
    with pytest.raises(jax_enc.PayloadCorruptionError):
        jagain.load_flat(rotten, "spill3")


def test_basic_spill_codec_requires_graph():
    kw = dict(chunk_rounds=1, steps_per_round=2, lanes=1, donate_k=1)
    with pytest.raises(ValueError, match="needs the instance graph"):
        spill.FrontierSpiller(enc.make_codec("basic", 12), 4, 32, (0.25, 0.75), **kw)


# -- 3. the device boundary ------------------------------------------------------


def _frontier(rng, lead, cap, W):
    shape = (*lead, cap)
    return Frontier(
        masks=t32(rng.integers(0, 2**32, size=(*shape, W), dtype=np.uint32)),
        sols=t32(rng.integers(0, 2**32, size=(*shape, W), dtype=np.uint32)),
        depths=torch.from_numpy(rng.integers(0, 50, size=shape).astype(np.int32)),
        active=torch.from_numpy(rng.random(shape) < 0.5),
        overflow=torch.ones(lead, dtype=torch.bool),
        dropped=torch.full(lead, 3, dtype=torch.int32),
    )


def test_pool_boundary_round_trips_bits_in_place():
    rng = np.random.default_rng(0)
    f = _frontier(rng, (4,), 8, 2)
    m, s, d, a = read_pool(f)
    assert (m.dtype, s.dtype, d.dtype, a.dtype) == (np.uint32, np.uint32, np.int32, bool)
    assert m.tobytes() == f.masks.numpy().tobytes()
    m[:] = 0xFFFFFFFF  # the sign bit of every word set
    d[:] = 7
    a[:] = ~a
    masks_before = f.masks
    write_pool(f, m, s, d, a)
    assert f.masks is masks_before  # written in place
    assert (f.masks == -1).all() and (f.depths == 7).all()
    assert (f.active.numpy() == a).all()
    assert f.overflow.all() and (f.dropped == 3).all()  # untouched

    lanes = _frontier(rng, (3, 4), 8, 2)
    before = [x.clone() for x in lanes]
    m, s, d, a = read_lane_pool(lanes, 1)
    assert m.tobytes() == lanes.masks[1].numpy().tobytes()
    write_lane_pool(lanes, 1, m ^ np.uint32(0x80000000), s, d + 1, ~a)
    assert (lanes.masks[1] == before[0][1] ^ torch.tensor(-2**31, dtype=torch.int32)).all()
    assert (lanes.depths[1] == before[2][1] + 1).all()
    for x, y in zip(lanes, before):  # other lanes untouched
        assert torch.equal(x[0], y[0]) and torch.equal(x[2], y[2])


# -- 4. whole spilled solves -----------------------------------------------------


def _both(problem, gen, args, **cfg):
    g = getattr(generators, gen)(*args)
    jg = getattr(jax_gen, gen)(*args)
    ours = SolverSession(problem, config=SolveConfig(**cfg), **CPU).solve(g)
    theirs = JaxSession(problem, config=JaxConfig(**cfg)).solve(jg)
    return g, _fields(ours), _fields(theirs)


@pytest.mark.parametrize("codec,cold_peak", [("optimized", 60), ("basic", 1020)])
def test_solo_spilled_vc_equals_jax(codec, cold_peak):
    g, ours, theirs = _both("vertex_cover", "erdos_renyi", (40, 0.28, 0),
                            **_SAT, frontier_spill=True, spill_codec=codec)
    assert ours == theirs
    assert (ours["best_size"], ours["rounds"], ours["spilled_tasks"],
            ours["readmitted_tasks"], ours["cold_bytes_peak"]) == (29, 21, 8, 8, cold_peak)
    assert ours["overflow_count"] == 0 and not ours["overflow"]
    assert verify_cover(g, np.asarray(ours["best_sol"], np.uint32))


def test_solo_unsaturated_and_starved_equal_jax():
    """The unsaturated reference of the spilled solves (22 rounds), and a
    starved capacity without spill, which drops tasks."""
    _, ours, theirs = _both("vertex_cover", "erdos_renyi", (40, 0.28, 0),
                            **{**_SAT, "capacity": None})
    assert ours == theirs and (ours["best_size"], ours["rounds"]) == (29, 22)
    _, ours, theirs = _both("vertex_cover", "erdos_renyi", (40, 0.28, 0),
                            **{**_SAT, "capacity": 8})
    assert ours == theirs and ours["overflow_count"] > 0


@pytest.mark.parametrize("k,found", [(29, True), (20, False)])
def test_solo_spilled_fpt_equals_jax(k, found):
    _, ours, theirs = _both("vertex_cover", "erdos_renyi", (40, 0.28, 0),
                            **_SAT, frontier_spill=True, mode="fpt", k=k)
    assert ours == theirs
    assert ours["found"] is found and ours["overflow_count"] == 0
    if found:
        assert ours["spilled_tasks"] > 0


@pytest.mark.parametrize("problem,args,cap", [
    ("max_clique", (30, 0.5, 0), 10),
    ("mis", (30, 0.2, 0), 16),
])
def test_solo_spilled_clique_and_mis_equal_jax(problem, args, cap):
    _, ours, theirs = _both(problem, "erdos_renyi", args,
                            **{**_SAT, "capacity": cap}, frontier_spill=True)
    assert ours == theirs
    assert ours["spilled_tasks"] > 0 and ours["overflow_count"] == 0
    assert ours["readmitted_tasks"] == ours["spilled_tasks"]


def test_solve_many_spilled_equals_jax_across_a_compaction():
    specs = [(40, 0.28, s) for s in range(3)] + [(18, 0.35, 2)]
    cfg = dict(**_SAT, frontier_spill=True, compact_threshold=0.7)
    ours = SolverSession(config=SolveConfig(**cfg), **CPU).solve_many(
        [generators.erdos_renyi(*a) for a in specs])
    theirs = JaxSession(config=JaxConfig(**cfg)).solve_many(
        [jax_gen.erdos_renyi(*a) for a in specs])
    assert ours.compactions == theirs.compactions == 1
    assert [_fields(r) for r in ours.results] == [_fields(r) for r in theirs.results]
    assert sum(r.stats.spilled_tasks for r in ours.results) > 0
    assert ours.lane_stats.chunk_calls == theirs.lane_stats.chunk_calls


def test_service_spilled_equals_jax_step_by_step():
    gs = [(40, 0.28, s) for s in range(3)]
    cfg = dict(**_SAT, frontier_spill=True, service_lanes=2)
    clock = FakeClock()
    svc = SolveService("vertex_cover", SolveConfig(**cfg), clock=clock, **CPU)
    jsvc = JaxService("vertex_cover", JaxConfig(**cfg), clock=clock)
    tickets = [svc.submit(generators.erdos_renyi(*a)) for a in gs]
    assert [jsvc.submit(jax_gen.erdos_renyi(*a)) for a in gs] == tickets
    while not jsvc.idle():
        clock.t += 0.25
        assert svc.step() == jsvc.step()
        assert svc.tickets() == jsvc.tickets()
    assert svc.idle()
    ref = SolverSession(config=SolveConfig(**cfg), **CPU).solve_many(
        [generators.erdos_renyi(*a) for a in gs])
    for t, want in zip(tickets, ref.results):
        got, jgot = svc.result(t), jsvc.result(t)
        assert _fields(got) == _fields(jgot)
        assert got.stats.service.__dict__ == jgot.stats.service.to_dict(), t
        # a lane's spill equals solve_many's (tests/test_spill.py's claim)
        assert got.stats.spilled_tasks == want.stats.spilled_tasks
    st, jst = svc.stats(), jsvc.stats()
    for key in ("completed", "steps", "chunk_calls", "lane_chunks", "live_lane_chunks"):
        assert st[key] == jst[key], key


def test_undersized_capacity_raises_at_solve_start():
    cfg = dict(num_workers=4, steps_per_round=8, capacity=2, frontier_spill=True)
    g, jg = generators.erdos_renyi(18, 0.35, 2), jax_gen.erdos_renyi(18, 0.35, 2)
    with pytest.raises(ValueError, match="headroom") as ours:
        SolverSession(config=SolveConfig(**cfg), **CPU).solve(g)
    with pytest.raises(ValueError, match="headroom") as theirs:
        JaxSession(config=JaxConfig(**cfg)).solve(jg)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="headroom"):
        SolverSession(config=SolveConfig(**cfg), **CPU).solve_many([g])
    svc = SolveService("vertex_cover", SolveConfig(**cfg, service_lanes=2), **CPU)
    svc.submit(g)
    with pytest.raises(ValueError, match="headroom"):
        svc.step()


def test_launch_solve_spill_flags_print_the_jax_line(capsys, monkeypatch):
    """``--spill``/``--spill-codec`` map onto the config as in the JAX CLI,
    and the ``[solve]`` line carries the same spill counters."""
    from repro.launch import solve as jax_solve
    from repro_torch.launch import solve

    flags = ["--n", "40", "--p", "0.28", "--seed", "0", "--workers", "4",
             "--steps-per-round", "2", "--chunk-rounds", "2", "--capacity", "16",
             "--spill", "--spill-codec", "basic"]

    def line():
        out = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[solve] best=")]
        assert len(out) == 1
        return out[0].split(" wall=")[0], out[0].split("overflow=")[1]

    solve.main(["--device", "cpu"] + flags)
    ours = line()
    monkeypatch.setattr("sys.argv", ["solve"] + flags)  # the JAX CLI reads argv
    jax_solve.main()
    assert ours == line()
    assert "spilled=8 readmitted=8 cold_peak=1020B" in ours[1]


def test_cold_tier_round_trips_through_both_stores(tmp_path):
    """A cold tier with zero-row blocks and int64 counters, written by either
    package's checkpoint store (the port's through its own MessagePack
    codec), reads back in both with the same names, dtypes and values."""
    from repro.checkpoint.solve import SolveCheckpoint as JaxCheckpoint
    from repro_torch.checkpoint.solve import SolveCheckpoint

    rng = np.random.default_rng(5)
    ours, _ = _spillers(5, (0.25, 0.75))
    ours.pump_host(*_random_pool(rng, 4, 32, ours.codec.W, [32, 31, 0, 2]))
    flat = ours.to_flat("plane0/spill1")
    assert any(v.shape[0] == 0 for k, v in flat.items() if ".w" in k)
    for cls, sub in ((SolveCheckpoint, "port"), (JaxCheckpoint, "jax")):
        d = str(tmp_path / sub)
        cls(kind="solo", problem="vertex_cover", config={}, fingerprint="x",
            rounds=3, arrays=dict(flat)).save(d, 3)
        for reader in (SolveCheckpoint, JaxCheckpoint):
            back = reader.load(d, 3).arrays
            for k, v in flat.items():
                assert back[k].dtype == v.dtype and back[k].shape == v.shape, (sub, k)
                assert back[k].tobytes() == v.tobytes(), (sub, k)
            again, _ = _spillers(5, (0.25, 0.75))
            again.load_flat(back, "plane0/spill1")
            _same_state(again, ours)
