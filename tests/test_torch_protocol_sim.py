"""The port's discrete-event simulators against the JAX package's.

``repro_torch.core.protocol_sim`` and ``repro_torch.core.centralized`` are
the port's own copies, on the port's codecs, graphs and problem plugins.
Each case feeds both packages the same seeded graph and requires exact
equality of the best value, the best solution, the ticks and every
``SimStats`` field (the message counts and bytes by tag included), beside
test_protocol_sim.py's own claims (the sequential optimum, zero failed
requests, safe termination under latency, a smaller control plane than the
centralized baseline).  Then the session: ``backend="protocol_sim"`` and
``"centralized"`` (and their aliases) for all three problems, ``to_dict()``
key for key with JAX's; test_system.py's three schedulers; and the CLI's
``[solve]`` line.
"""

import re

import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.core.centralized import run_centralized_sim as jax_centralized
from repro.core.protocol_sim import run_protocol_sim as jax_protocol
from repro.graphs import generators as jax_gen
from repro_torch.api import SolveConfig, SolverSession, get_backend, known_backends
from repro_torch.core.centralized import run_centralized_sim
from repro_torch.core.protocol_sim import run_protocol_sim
from repro_torch.graphs import generators as gen
from repro_torch.problems.sequential import (
    solve_sequential,
    solve_sequential_max_clique,
    solve_sequential_mis,
    verify_clique,
    verify_cover,
    verify_independent_set,
)
from tests._hypothesis_compat import given, settings, strategies as st


def sim_record(res) -> dict:
    """Every field of a ``SimResult``, JSON-comparable."""
    s = res.stats
    return {
        "best_size": int(res.best_size),
        "best_sol": None if res.best_sol is None
        else [int(w) for w in np.asarray(res.best_sol, np.uint32)],
        "ticks": int(res.ticks),
        "stats_ticks": int(s.ticks),
        "nodes_expanded": int(s.nodes_expanded),
        "tasks_transferred": int(s.tasks_transferred),
        "failed_requests": int(s.failed_requests),
        "termination_cancelled": int(s.termination_cancelled),
        "total_bytes": int(s.total_bytes),
        "center_bytes": int(s.center_bytes),
        "msg_count": dict(s.msg_count),
        "msg_bytes": dict(s.msg_bytes),
    }


def both(kind: str, generator: str, graph_args: tuple, **kw) -> dict:
    """Run one simulator of both packages on the same graph; assert every
    field equal and return the port's record."""
    ours_fn, theirs_fn = {
        "protocol": (run_protocol_sim, jax_protocol),
        "central": (run_centralized_sim, jax_centralized),
    }[kind]
    ours = sim_record(ours_fn(getattr(gen, generator)(*graph_args), **kw))
    theirs = sim_record(theirs_fn(getattr(jax_gen, generator)(*graph_args), **kw))
    assert ours == theirs
    return ours


# -- test_protocol_sim.py, held against JAX --------------------------------------


@pytest.mark.parametrize("policy", ["random", "priority"])
@pytest.mark.parametrize("codec", ["optimized", "basic"])
def test_matches_sequential_and_jax(policy, codec):
    g = gen.erdos_renyi(36, 0.25, 7)
    want, _, _ = solve_sequential(g)
    rec = both("protocol", "erdos_renyi", (36, 0.25, 7), num_workers=5,
               policy=policy, codec_name=codec)
    assert rec["best_size"] == want
    assert verify_cover(g, np.asarray(rec["best_sol"], np.uint32))
    assert rec["failed_requests"] == 0


@pytest.mark.parametrize("latency", [1, 2, 3, 5])
def test_latency_termination_race_equals_jax(latency):
    g = gen.erdos_renyi(32, 0.3, 3)
    want, _, _ = solve_sequential(g)
    rec = both("protocol", "erdos_renyi", (32, 0.3, 3), num_workers=6, latency=latency)
    assert rec["best_size"] == want and rec["failed_requests"] == 0


@pytest.mark.parametrize("latency", [1, 2, 3])
def test_centralized_latency_equals_jax(latency):
    g = gen.erdos_renyi(32, 0.3, 3)
    want, _, _ = solve_sequential(g)
    rec = both("central", "erdos_renyi", (32, 0.3, 3), num_workers=6, latency=latency)
    assert rec["best_size"] == want


def test_metadata_policy_equals_jax():
    g = gen.erdos_renyi(30, 0.3, 11)
    want, _, _ = solve_sequential(g)
    rec = both("protocol", "erdos_renyi", (30, 0.3, 11), num_workers=4,
               policy="priority", send_metadata=True)
    assert rec["best_size"] == want
    assert rec["msg_count"]["metadata"] > 0


@pytest.mark.parametrize("kind", ["protocol", "central"])
def test_fpt_mode_early_stop_equals_jax(kind):
    g = gen.erdos_renyi(30, 0.25, 5)
    opt, _, _ = solve_sequential(g)
    yes = both(kind, "erdos_renyi", (30, 0.25, 5), num_workers=4, mode="fpt", k=opt)
    assert yes["best_size"] != -1 and yes["best_size"] <= opt
    no = both(kind, "erdos_renyi", (30, 0.25, 5), num_workers=4, mode="fpt", k=opt - 1)
    assert no["best_size"] == -1 and no["best_sol"] is None


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 8))
def test_random_graphs_property_equals_jax(seed, workers):
    g = gen.erdos_renyi(26, 0.22, seed)
    want, _, _ = solve_sequential(g)
    rec = both("protocol", "erdos_renyi", (26, 0.22, seed), num_workers=workers, seed=seed)
    assert rec["best_size"] == want
    assert rec["failed_requests"] == 0
    if rec["best_sol"] is not None:
        assert verify_cover(g, np.asarray(rec["best_sol"], np.uint32))


@pytest.mark.parametrize("codec", ["optimized", "basic"])
@pytest.mark.parametrize("queue", [True, False])
def test_centralized_queue_and_codec_equal_jax(codec, queue):
    rec = both("central", "p_hat_like", (40, 0.4, 2), num_workers=5,
               codec_name=codec, use_priority_queue=queue)
    want, _, _ = solve_sequential(gen.p_hat_like(40, 0.4, 2))
    assert rec["best_size"] == want


def test_centralized_full_hysteresis_equals_jax():
    """A queue cap of 1 task a worker: the full/not-full flags fire."""
    rec = both("central", "erdos_renyi", (40, 0.25, 4), num_workers=3, queue_cap_per_p=1)
    assert rec["msg_count"]["full"] > 0 and rec["msg_count"]["not_full"] > 0


def test_control_plane_smaller_than_centralized():
    semi = both("protocol", "p_hat_like", (40, 0.4, 2), num_workers=5)
    cent = both("central", "p_hat_like", (40, 0.4, 2), num_workers=5)
    assert semi["best_size"] == cent["best_size"]
    assert semi["total_bytes"] < cent["total_bytes"]
    assert semi["center_bytes"] < semi["total_bytes"]


@pytest.mark.parametrize("kind", ["protocol", "central"])
@pytest.mark.parametrize("problem", ["max_clique", "mis"])
def test_other_problems_equal_jax(kind, problem):
    ref = {"max_clique": solve_sequential_max_clique, "mis": solve_sequential_mis}[problem]
    for seed in range(3):
        want, _, _ = ref(gen.erdos_renyi(20, 0.4, seed))
        rec = both(kind, "erdos_renyi", (20, 0.4, seed), num_workers=6, problem=problem)
        assert rec["best_size"] == want


# -- test_system.py: the three schedulers agree ----------------------------------


def test_three_schedulers_agree():
    g = gen.p_hat_like(36, 0.45, 1)
    want, _, _ = solve_sequential(g)
    semi = both("protocol", "p_hat_like", (36, 0.45, 1), num_workers=4)
    cent = both("central", "p_hat_like", (36, 0.45, 1), num_workers=4)
    spmd = SolverSession(config=SolveConfig(num_workers=4, steps_per_round=8),
                         device="cpu").solve(g)
    assert semi["best_size"] == cent["best_size"] == spmd.best_size == want
    assert verify_cover(g, spmd.best_sol)
    assert semi["failed_requests"] == 0


# -- the session: test_session.py's backend parity, held against JAX -------------


def _result_dict(r) -> dict:
    d = r.to_dict()
    d.pop("wall_s")
    return d


_VERIFY = {
    "vertex_cover": (solve_sequential, verify_cover),
    "max_clique": (solve_sequential_max_clique, verify_clique),
    "mis": (solve_sequential_mis, verify_independent_set),
}


@pytest.mark.parametrize("problem", ["vertex_cover", "max_clique", "mis"])
@pytest.mark.parametrize("backend", ["protocol_sim", "centralized"])
def test_session_backend_equals_jax(problem, backend):
    seq_ref, verify = _VERIFY[problem]
    cfg = dict(num_workers=4, steps_per_round=8)
    for seed in (0, 1, 2):
        g = gen.erdos_renyi(15, 0.35, seed)
        want, _, _ = seq_ref(g)
        r = SolverSession(problem=problem, backend=backend, config=SolveConfig(**cfg),
                          device="cpu").solve(g)
        j = JaxSession(problem=problem, backend=backend,
                       config=JaxConfig(**cfg)).solve(jax_gen.erdos_renyi(15, 0.35, seed))
        assert r.best_size == want, (problem, backend, seed)
        assert r.backend == backend and r.problem == problem and r.found
        assert verify(g, r.best_sol)
        assert _result_dict(r) == _result_dict(j)
        assert r.rounds == r.stats.ticks > 0


@pytest.mark.parametrize("alias,name", [
    ("protocol", "protocol_sim"), ("central", "centralized"), ("centralised", "centralized"),
])
def test_aliases_run_and_equal_jax(alias, name):
    cfg = dict(num_workers=5, codec="basic", latency=2)
    r = SolverSession(backend=alias, config=SolveConfig(**cfg), device="cpu").solve(
        gen.erdos_renyi(24, 0.3, 9))
    j = JaxSession(backend=alias, config=JaxConfig(**cfg)).solve(jax_gen.erdos_renyi(24, 0.3, 9))
    assert r.backend == name == get_backend(alias).name
    assert _result_dict(r) == _result_dict(j)


def test_session_fpt_and_solve_many_equal_jax():
    cfg = dict(num_workers=4, mode="fpt", k=[9, 8, 12])
    graphs = [gen.erdos_renyi(16, 0.35, s) for s in range(3)]
    jgraphs = [jax_gen.erdos_renyi(16, 0.35, s) for s in range(3)]
    for backend in ("protocol_sim", "centralized"):
        ours = SolverSession(backend=backend, config=SolveConfig(**cfg),
                             device="cpu").solve_many(graphs)
        theirs = JaxSession(backend=backend, config=JaxConfig(**cfg)).solve_many(jgraphs)
        assert [_result_dict(r) for r in ours] == [_result_dict(r) for r in theirs]


def test_result_round_trip_keeps_the_simulator_counters():
    r = SolverSession(backend="protocol_sim", config=SolveConfig(num_workers=4),
                      device="cpu").solve(gen.erdos_renyi(20, 0.3, 1))
    again = type(r).from_dict(r.to_dict())
    assert again.stats == r.stats
    assert again.stats.msg_bytes == r.stats.msg_bytes and r.stats.total_bytes > 0
    # a JAX simulator result's dict carries the same counters into the port
    j = JaxSession(backend="protocol_sim", config=JaxConfig(num_workers=4)).solve(
        jax_gen.erdos_renyi(20, 0.3, 1))
    assert type(r).from_dict(j.to_dict()).stats == r.stats


def test_reduce_sweeps_only_in_the_engine_dict():
    """The port's own ``reduce_sweeps`` rides in the SPMD engine's dict and
    round-trips; a host backend counts none, so its dict has the JAX
    package's keys exactly."""
    g, jg = gen.erdos_renyi(20, 0.3, 1), jax_gen.erdos_renyi(20, 0.3, 1)
    cfg = dict(num_workers=4)
    spmd = SolverSession(config=SolveConfig(**cfg), device="cpu").solve(g)
    assert spmd.stats.reduce_sweeps > 0
    assert type(spmd).from_dict(spmd.to_dict()).stats == spmd.stats
    for backend in ("protocol_sim", "centralized", "sequential"):
        r = SolverSession(backend=backend, config=SolveConfig(**cfg), device="cpu").solve(g)
        j = JaxSession(backend=backend, config=JaxConfig(**cfg)).solve(jg)
        assert r.stats.reduce_sweeps is None
        assert r.to_dict().keys() == j.to_dict().keys()
        assert r.to_dict()["stats"].keys() == j.to_dict()["stats"].keys()
        assert type(r).from_dict(r.to_dict()).stats == r.stats


def test_backend_registry_equals_jax():
    from repro.api import known_backends as jax_known

    assert known_backends() == jax_known()
    with pytest.raises(ValueError, match="protocol_sim"):
        get_backend("mpi")
    assert get_backend("protocol").name == "protocol_sim"
    assert get_backend("central").name == "centralized"
    assert get_backend("seq").name == "sequential"


def test_problem_without_host_bounds_is_refused_by_name():
    import dataclasses

    from repro_torch.problems.registry import get_problem

    spec = dataclasses.replace(get_problem("max_clique"), name="clique_no_host",
                               host_task_bound=None, host_terminal_value=None)
    for backend in ("protocol_sim", "centralized"):
        with pytest.raises(ValueError, match="host_task_bound, host_terminal_value"):
            SolverSession(problem=spec, backend=backend, device="cpu").solve(
                gen.erdos_renyi(10, 0.4, 0))


def test_simulator_session_still_needs_cuda_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("protocol_sim", "centralized"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SolverSession(backend=backend)


# -- the CLI ----------------------------------------------------------------------

_WALL = re.compile(r" wall=[0-9.]+s")


@pytest.mark.parametrize("argv", [
    ["--n", "40", "--engine", "protocol_sim", "--workers", "8"],
    ["--n", "40", "--engine", "centralized", "--workers", "8", "--latency", "2"],
    ["--n", "20", "--p", "0.4", "--problem", "max_clique", "--engine", "protocol",
     "--workers", "6", "--codec", "basic", "--policy", "random"],
])
def test_cli_line_equals_jax(argv, capsys, monkeypatch):
    from repro.launch import solve as jax_cli
    from repro_torch.launch import solve as cli

    cli.main(argv + ["--device", "cpu"])
    ours = _WALL.sub("", capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["solve"] + argv)
    jax_cli.main()
    theirs = _WALL.sub("", capsys.readouterr().out)
    assert ours == theirs
    assert "bytes=" in ours
