"""The port's checkpoint store and schema on the CPU, held against the JAX
package's.

* ``tests/test_checkpoint.py``'s store and schema tests (all but the
  training loss curve, which waits for the LM trainer) on
  ``repro_torch.checkpoint``: the round trip and ``extra``,
  ``latest_step`` ignoring tmp dirs, the async write, a kill mid-write
  leaving the previous step intact, truncated/corrupt/missing files as
  ``CheckpointError``, a raw store checkpoint refused as a solve
  checkpoint, a fingerprint mismatch refused while ``max_rounds`` may
  change;
* the port's MessagePack codec byte for byte against ``msgpack`` on the
  manifests of real JAX and port checkpoints of every kind, and on a
  hypothesis strategy over the manifest types with ints and strs at every
  width boundary;
* one file format: a store tree written by either package restores in the
  other, and a solo, many and service checkpoint of the same solve has the
  same fingerprint, graph digests, npz keys, dtypes and shapes in both;
* ``tests/test_faults.py``'s ``test_corrupt_generation_falls_back_to_older``
  on the port: a corrupt newest generation falls back loudly to an older
  one; all generations corrupt fails with ``CheckpointError``.
"""

import os
import pathlib

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import SolveConfig as JaxConfig
from repro.api import SolveService as JaxService
from repro.api import SolverSession as JaxSession
from repro.checkpoint import solve as jax_ckpt
from repro.checkpoint import store as jax_store
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.api import PlaneCache, SolveConfig, SolveService, SolverSession
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import solve as ckpt
from repro_torch.checkpoint.solve import CheckpointError, SolveCheckpoint
from repro_torch.checkpoint.store import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending,
)
from repro_torch.graphs.generators import erdos_renyi

CPU = dict(device="cpu")
SMALL = dict(num_workers=4, steps_per_round=2, chunk_rounds=1, checkpoint_every=1)
MANY_SIZES = [(20, 1), (30, 2), (34, 3), (18, 4), (33, 5), (26, 6)]


# -- the store (tests/test_checkpoint.py) ---------------------------------------


def test_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(str(tmp_path), 5, tree, extra={"x": 1})
    got, step, extra = restore_checkpoint(str(tmp_path), tree, **CPU)
    assert step == 5 and extra == {"x": 1}
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.int32 and int(got["b"]["c"]) == 7
    # the JAX package's key for each dict leaf
    with np.load(tmp_path / "step_5" / "arrays.npz") as z:
        assert sorted(z.files) == ["['a']", "['b']/['c']"]


def test_latest_step_and_atomicity(tmp_path):
    tree = {"a": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 9, tree)
    # a stale .tmp dir must be ignored
    os.makedirs(tmp_path / "step_50.tmp")
    assert latest_step(str(tmp_path)) == 9


def test_async_write(tmp_path):
    tree = {"a": torch.ones((64, 64))}
    save_checkpoint(str(tmp_path), 3, tree, blocking=False)
    wait_for_pending()
    got, step, _ = restore_checkpoint(str(tmp_path), tree, **CPU)
    assert step == 3 and float(got["a"].sum()) == 64 * 64


def test_kill_mid_write_leaves_previous_step_intact(tmp_path, monkeypatch):
    """A writer dying inside the npz write (the long I/O phase) leaves the
    directory as it was: latest_step unchanged, no tmp litter, and the
    previous step still restorable."""
    tree = {"a": torch.arange(8.0)}
    save_checkpoint(str(tmp_path), 1, tree, extra={"x": "old"})

    real_savez = np.savez

    def dying_savez(path, **payload):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 partial garbage")  # half-written archive
        raise RuntimeError("simulated kill mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(RuntimeError, match="simulated kill"):
        save_checkpoint(str(tmp_path), 2, {"a": torch.zeros(8)}, extra={"x": "new"})
    monkeypatch.setattr(np, "savez", real_savez)

    assert latest_step(str(tmp_path)) == 1
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    got, step, extra = restore_checkpoint(str(tmp_path), tree, **CPU)
    assert step == 1 and extra == {"x": "old"}
    assert torch.equal(got["a"], torch.arange(8.0))


def _dummy_solve_checkpoint():
    return SolveCheckpoint(
        kind="solo",
        problem="vertex_cover",
        config={},
        fingerprint="f" * 64,
        rounds=3,
        arrays={"worker.rounds": np.arange(4, dtype=np.int32)},
    )


def test_truncated_solve_checkpoint_raises_checkpoint_error(tmp_path):
    step_dir = _dummy_solve_checkpoint().save(str(tmp_path), 3)
    npz = os.path.join(step_dir, "arrays.npz")
    with open(npz, "r+b") as f:  # truncate mid-archive
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        SolveCheckpoint.load(str(tmp_path))


def test_corrupt_manifest_raises_checkpoint_error(tmp_path):
    step_dir = _dummy_solve_checkpoint().save(str(tmp_path), 1)
    with open(os.path.join(step_dir, "manifest.msgpack"), "wb") as f:
        f.write(b"\xc1\xc1 not msgpack")
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        SolveCheckpoint.load(step_dir)  # step_<N> path form


def test_missing_manifest_raises_checkpoint_error(tmp_path):
    step_dir = _dummy_solve_checkpoint().save(str(tmp_path), 1)
    os.remove(os.path.join(step_dir, "manifest.msgpack"))
    with pytest.raises(CheckpointError, match="incomplete checkpoint"):
        SolveCheckpoint.load(str(tmp_path))


def test_raw_store_checkpoint_is_not_a_solve_checkpoint(tmp_path):
    save_checkpoint(str(tmp_path), 4, {"a": torch.zeros(2)}, extra={"x": 1})
    with pytest.raises(CheckpointError, match="not a solve checkpoint"):
        SolveCheckpoint.load(str(tmp_path))


def test_fingerprint_mismatch_refuses_resume(tmp_path):
    """Resuming under a changed trajectory knob (num_workers) refuses with
    CheckpointError instead of running a different solve; a changed
    post-trajectory knob is allowed."""
    g = erdos_renyi(24, 0.3, seed=5)
    d = str(tmp_path / "ck")
    SolverSession(config=SolveConfig(**SMALL), **CPU).solve(g, checkpoint_dir=d)
    assert latest_step(d) is not None
    with pytest.raises(CheckpointError, match="fingerprint mismatch"):
        SolverSession.resume(d, num_workers=8, **CPU)
    r = SolverSession.resume(d, max_rounds=10_000, **CPU)
    assert r.found


# -- the MessagePack codec ------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One checkpoint of each kind written by each package on the same
    solves: {(package, kind): checkpoint dir}."""
    root = tmp_path_factory.mktemp("both")
    out = {}
    kw = dict(SMALL)
    out["jax", "solo"] = str(root / "jax_solo")
    JaxSession(config=JaxConfig(**kw)).solve(
        jax_erdos_renyi(34, 0.25, seed=3), checkpoint_dir=out["jax", "solo"]
    )
    out["port", "solo"] = str(root / "port_solo")
    SolverSession(config=SolveConfig(**kw), **CPU).solve(
        erdos_renyi(34, 0.25, seed=3), checkpoint_dir=out["port", "solo"]
    )
    out["jax", "many"] = str(root / "jax_many")
    JaxSession(config=JaxConfig(**kw)).solve_many(
        [jax_erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES],
        checkpoint_dir=out["jax", "many"],
    )
    out["port", "many"] = str(root / "port_many")
    SolverSession(config=SolveConfig(**kw), **CPU).solve_many(
        [erdos_renyi(n, 0.3, seed=s) for n, s in MANY_SIZES],
        checkpoint_dir=out["port", "many"],
    )
    svc_kw = dict(num_workers=4, steps_per_round=2, chunk_rounds=1, service_lanes=2,
                  mode="fpt", k=30)
    jsvc = JaxService("vertex_cover", JaxConfig(**svc_kw))
    psvc = SolveService("vertex_cover", SolveConfig(**svc_kw), **CPU)
    for n, s in MANY_SIZES[:4]:
        jsvc.submit(jax_erdos_renyi(n, 0.3, seed=s), deadline=5, tenant="a")
        psvc.submit(erdos_renyi(n, 0.3, seed=s), deadline=5, tenant="a")
    for svc in (jsvc, psvc):
        svc.step()
        svc.step()
    out["jax", "service"] = str(root / "jax_service")
    jsvc.checkpoint(out["jax", "service"])
    out["port", "service"] = str(root / "port_service")
    psvc.checkpoint(out["port", "service"])
    return out


def _manifests(d):
    return [
        (d / step / "manifest.msgpack").read_bytes()
        for step in sorted(os.listdir(d))
    ]


@pytest.mark.parametrize("kind", ["solo", "many", "service"])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_codec_matches_msgpack_on_real_manifests(checkpoints, package, kind):
    raws = _manifests(pathlib.Path(checkpoints[package, kind]))
    assert raws
    for raw in raws:
        want = msgpack.unpackb(raw, strict_map_key=False)
        assert _msgpack.unpackb(raw, strict_map_key=False) == want
        assert _msgpack.packb(want) == raw == msgpack.packb(want)


_WIDTHS = [
    0, 1, 2**5 - 1, 2**5, 2**7 - 1, 2**7, 2**8 - 1, 2**8, 2**15 - 1, 2**15,
    2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
    2**64 - 1,
]
BOUNDARY_INTS = sorted(
    {v for w in _WIDTHS for v in (w, -w, -w - 1) if -(2**63) <= v < 2**64}
)
BOUNDARY_LENGTHS = [0, 1, 31, 32, 255, 256, 65535, 65536]

_scalars = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(-(2**63), 2**64 - 1),
    st.sampled_from(BOUNDARY_INTS),
    st.floats(allow_nan=False),
    st.text(max_size=40),
    st.sampled_from(BOUNDARY_LENGTHS).map(lambda n: "é" * (n // 2) + "x" * (n % 2)),
    st.sampled_from(BOUNDARY_LENGTHS).map(lambda n: "x" * n),
    st.binary(max_size=40),
    st.sampled_from(BOUNDARY_LENGTHS).map(lambda n: b"\x00" * n),
)
_objects = st.recursive(
    _scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.text(max_size=8), inner, max_size=20),
    ),
    max_leaves=30,
)


@settings(max_examples=300, deadline=None)
@given(_objects)
def test_codec_matches_msgpack_on_generated_objects(obj):
    raw = msgpack.packb(obj)
    assert _msgpack.packb(obj) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw)


@pytest.mark.parametrize("v", BOUNDARY_INTS)
def test_codec_int_widths(v):
    assert _msgpack.packb(v) == msgpack.packb(v)
    assert _msgpack.unpackb(msgpack.packb(v)) == v


def test_codec_refuses_what_msgpack_refuses():
    with pytest.raises(TypeError):
        _msgpack.packb(np.int64(3))
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)
    with pytest.raises(ValueError, match="map key"):
        _msgpack.unpackb(msgpack.packb({1: 2}))
    assert _msgpack.unpackb(msgpack.packb({1: 2}), strict_map_key=False) == {1: 2}
    for bad in (b"\xc1", b"\x92\x01", msgpack.packb(1) + b"\x00", b"\xd4\x01\x00"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)


# -- one file format ------------------------------------------------------------


def test_store_trees_cross_packages(tmp_path):
    """A nested tree saved by either package restores in the other."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(3, 5), dtype=np.uint32)
    vals = rng.integers(-9, 9, size=(4,), dtype=np.int32)
    jax_store.save_checkpoint(
        str(tmp_path / "j"), 2, {"w": jnp.asarray(words), "b": {"v": jnp.asarray(vals)}},
        extra={"by": "jax"},
    )
    template = {"w": torch.zeros((3, 5), dtype=torch.int32),
                "b": {"v": torch.zeros(4, dtype=torch.int32)}}
    got, step, extra = restore_checkpoint(str(tmp_path / "j"), template, **CPU)
    assert step == 2 and extra == {"by": "jax"}
    assert (got["w"].numpy().view(np.uint32) == words).all()
    assert (got["b"]["v"].numpy() == vals).all()

    save_checkpoint(str(tmp_path / "p"), 3, {"w": words, "b": {"v": torch.from_numpy(vals)}},
                    extra={"by": "port"})
    back, step, extra = jax_store.restore_checkpoint(
        str(tmp_path / "p"), {"w": jnp.zeros((3, 5), jnp.uint32),
                              "b": {"v": jnp.zeros(4, jnp.int32)}},
    )
    assert step == 3 and extra == {"by": "port"}
    assert (np.asarray(back["w"]) == words).all()
    assert (np.asarray(back["b"]["v"]) == vals).all()


@pytest.mark.parametrize("kind", ["solo", "many", "service"])
def test_same_solve_same_checkpoint_layout(checkpoints, kind):
    """The two packages' checkpoints of one solve agree in fingerprint,
    graph digests, array names, npz keys, dtypes and shapes, and in every
    array of the solo and batched kinds (the service's lanes of two
    services on their own clocks too)."""
    jdir, pdir = checkpoints["jax", kind], checkpoints["port", kind]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for step in sorted(os.listdir(jdir)):
        j = jax_ckpt.SolveCheckpoint.load(os.path.join(jdir, step))
        p = SolveCheckpoint.load(os.path.join(pdir, step))
        assert (p.kind, p.problem, p.rounds, p.fingerprint) == (
            j.kind, j.problem, j.rounds, j.fingerprint)
        assert sorted(p.arrays) == sorted(j.arrays)
        for name, want in j.arrays.items():
            got = p.arrays[name]
            assert (got.dtype, got.shape) == (want.dtype, want.shape), name
            assert (got == want).all(), name
        with np.load(os.path.join(jdir, step, "arrays.npz")) as zj, \
                np.load(os.path.join(pdir, step, "arrays.npz")) as zp:
            assert zj.files == zp.files
        assert {t: ckpt.graph_digest(p.unpack_graph(t)) for t in p.meta["graph_ns"]} == {
            t: jax_ckpt.graph_digest(j.unpack_graph(t)) for t in j.meta["graph_ns"]}
        cfg_p = SolveConfig.from_dict(p.config)
        cfg_j = JaxConfig.from_dict(j.config)
        # a service's fingerprint holds no graphs: its tickets come and go
        graphs = [] if kind == "service" else [
            ckpt.graph_digest(g) for g in p.unpack_graphs()]
        assert ckpt.config_fingerprint(kind, p.problem, cfg_p, graphs) == \
            jax_ckpt.config_fingerprint(kind, j.problem, cfg_j, graphs) == p.fingerprint


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(mode="fpt", k=12), dict(k=(3, 4), mode="fpt"),
     dict(spill_watermarks=(0.25, 0.5), frontier_spill=True, lanes=2),
     dict(tenant_max_lanes=2, admission="fifo", capacity=40)],
    ids=["default", "fpt", "k_tuple", "spill_knobs", "service_knobs"],
)
def test_config_fingerprint_matches_jax(kw):
    digests = [ckpt.graph_digest(erdos_renyi(20, 0.3, seed=s)) for s in range(2)]
    assert digests == [jax_ckpt.graph_digest(jax_erdos_renyi(20, 0.3, seed=s))
                       for s in range(2)]
    for kind in ("solo", "many", "service"):
        assert ckpt.config_fingerprint(kind, "max_clique", SolveConfig(**kw), digests) == \
            jax_ckpt.config_fingerprint(kind, "max_clique", JaxConfig(**kw), digests)


# -- corruption (tests/test_faults.py) ------------------------------------------


def _corrupt(step_dir) -> None:
    p = step_dir / "arrays.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))


def test_corrupt_generation_falls_back_to_older(tmp_path):
    g = erdos_renyi(24, 0.3, 2)
    cache = PlaneCache()
    sess = SolverSession("vertex_cover", config=SolveConfig(**SMALL), cache=cache, **CPU)
    base = sess.solve(g)
    sess.solve(g, checkpoint_dir=str(tmp_path))
    steps = sorted(
        int(p.name.split("_")[1])
        for p in tmp_path.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".prev")
    )
    assert len(steps) >= 2

    # newest generation corrupt: resume warns loudly and replays from the
    # older one, landing on the same answer
    _corrupt(tmp_path / f"step_{steps[-1]}")
    with pytest.warns(RuntimeWarning, match="OLDER checkpoint generation"):
        res = SolverSession.resume(str(tmp_path), cache=cache, **CPU)
    assert res.best_size == base.best_size and res.rounds == base.rounds
    assert (np.asarray(res.best_sol) == np.asarray(base.best_sol)).all()

    # every generation corrupt: fail loudly, not silently from scratch
    for s in steps:
        _corrupt(tmp_path / f"step_{s}")
    with pytest.raises(CheckpointError, match="corrupt|checksum"):
        SolveCheckpoint.load_latest_good(str(tmp_path))
    with pytest.raises(CheckpointError, match="corrupt|checksum"):
        SolverSession.resume(str(tmp_path), cache=cache, **CPU)
