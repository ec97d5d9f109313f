"""The port's mesh superstep against the JAX package's ``shard_map`` one,
leaf for leaf after every superstep.

JAX runs ``build_superstep_fn(mesh=make_solver_mesh(4))`` in a subprocess
that sees 4 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
which must be set before jax starts); the port runs its
``build_superstep_fn(mesh=...)`` on 4 gloo ranks (one ``spawn_mesh`` job)
at the same time.  Vertex cover on G(40, 0.2, seed 3), 4 explore rounds a
superstep: the whole state (gathered from the ranks' blocks) equals JAX's
after the startup and after every superstep to ``done``, for the fused
sparse plane, the gather plane, ``packed_status=False`` and
``skip_empty_transfer=False``.  And the port's mesh ``build_chunk_fn``
(chunks of 3 supersteps) against JAX's ``build_chunk_fn`` without a mesh
(JAX's mesh chunk runner raises on jax 0.9.0: ROADMAP section 3): the same
state, ``done``, ``ran`` and per-worker pending after every chunk.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_jobs as jobs
from _torch_parity import assert_flat_equal
from repro_torch.launch.mesh import spawn_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRAPH = dict(n=40, p=0.2, seed=3)
MAX_STEPS = 32
CHUNK_ROUNDS = 3
CASES = [
    ("fused_sparse", {}),
    ("gather", {"transfer_impl": "gather"}),
    ("unpacked_status", {"packed_status": False}),
    ("no_skip_empty", {"skip_empty_transfer": False}),
]
TIMEOUT_S = 300.0

_JAX_SCRIPT = """
import json, sys
import jax
import numpy as np
from repro.core import engine as E
from repro.core import superstep as S
from repro.graphs.generators import erdos_renyi
from repro.launch.mesh import make_solver_mesh
from repro.problems.base import make_data
from repro.problems.registry import get_problem

out, graph, cases, max_steps, chunk_rounds = sys.argv[1], *map(json.loads, sys.argv[2:])
assert len(jax.devices()) == 4, jax.devices()
spec = get_problem("vertex_cover")
g = erdos_renyi(graph["n"], graph["p"], graph["seed"])
data = make_data(spec, g)
mesh = make_solver_mesh(4)
arrays = {}
for label, knobs in cases:
    state = E.make_instance_state(spec, g, 4, 4 * g.n + 8, g.W, g.n + 1)
    step = S.build_superstep_fn(spec, data, num_workers=4, steps_per_round=4,
                                lanes=1, explore_impl="fused", mesh=mesh, **knobs)
    flats, dones = [S.worker_state_to_flat(jax.device_get(state))], [False]
    for _ in range(max_steps):
        state, done = step(state)
        flats.append(S.worker_state_to_flat(jax.device_get(state)))
        dones.append(bool(done))
        if dones[-1]:
            break
    for i, flat in enumerate(flats):
        for name, v in flat.items():
            arrays[f"{label}/{i}/{name}"] = np.asarray(v)
    arrays[f"{label}/done"] = np.array(dones)
# the chunk runner without a mesh (vmap): the trajectory the mesh's must equal
chunk = S.build_chunk_fn(spec, data, num_workers=4, steps_per_round=4, lanes=1,
                         explore_impl="fused", chunk_rounds=chunk_rounds)
state = E.make_instance_state(spec, g, 4, 4 * g.n + 8, g.W, g.n + 1)
for i in range(max_steps):
    state, done, ran, hot = chunk(state)
    for name, v in S.worker_state_to_flat(jax.device_get(state)).items():
        arrays[f"chunk/{i}/{name}"] = np.asarray(v)
    arrays[f"chunk/{i}/meta"] = np.array([bool(done), int(ran)])
    arrays[f"chunk/{i}/hot"] = np.asarray(hot)
    if bool(done):
        break
np.savez(out, **arrays)
"""


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """(JAX's arrays, the port's rank results), run side by side."""
    out = tmp_path_factory.mktemp("jax_mesh") / "trajectories.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(out), json.dumps(GRAPH), json.dumps(CASES),
         json.dumps(MAX_STEPS), json.dumps(CHUNK_ROUNDS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        parts = [("supersteps", "superstep_trajectories", (GRAPH, CASES, MAX_STEPS)),
                 ("chunks", "chunk_trajectory", (GRAPH, CHUNK_ROUNDS, MAX_STEPS))]
        port = spawn_mesh(jobs.job, 4, device="cpu", timeout_s=TIMEOUT_S, args=(parts,))
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    with np.load(out) as f:
        return dict(f), port


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_superstep_equals_jax_shard_map_superstep(label, trajectories):
    want, ranks = trajectories
    got = ranks[0]["supersteps"][label]
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    assert all(_same(r["supersteps"][label], got) for r in ranks[1:])
    dones = [bool(d) for d in want[f"{label}/done"]]
    assert [d for _, d in got] == dones
    assert dones[-1] and len(dones) > 3  # the run went to done, over several steps
    for i, (flat, _) in enumerate(got):
        jax_flat = {k.split("/", 2)[2]: v for k, v in want.items()
                    if k.startswith(f"{label}/{i}/")}
        assert_flat_equal(jax_flat, flat)


def _same(a, b) -> bool:
    """Two ranks' trajectories hold equal arrays."""
    return len(a) == len(b) and all(
        da == db and fa.keys() == fb.keys() and all((fa[k] == fb[k]).all() for k in fa)
        for (fa, da), (fb, db) in zip(a, b)
    )


def test_the_trajectories_move_tasks(trajectories):
    """Every case's run ships tasks between ranks, so the data plane ran."""
    _, ranks = trajectories
    for label, _ in CASES:
        flat, _ = ranks[0]["supersteps"][label][-1]
        assert flat["worker.tasks_sent"].sum() > 0, label
        assert flat["worker.tasks_recv"].sum() == flat["worker.tasks_sent"].sum(), label


def test_mesh_chunk_runner_equals_jax_chunk_runner(trajectories):
    want, ranks = trajectories
    got = ranks[0]["chunks"]
    n = len({k.split("/")[1] for k in want if k.startswith("chunk/")})
    assert len(got) == n > 2
    for i, (flat, done, ran, hot) in enumerate(got):
        assert [done, ran] == want[f"chunk/{i}/meta"].tolist()
        assert (hot == want[f"chunk/{i}/hot"]).all()
        jax_flat = {k.split("/", 2)[2]: v for k, v in want.items()
                    if k.startswith(f"chunk/{i}/") and not k.endswith(("/meta", "/hot"))}
        assert_flat_equal(jax_flat, flat)
    assert got[-1][1]  # the run went to done
