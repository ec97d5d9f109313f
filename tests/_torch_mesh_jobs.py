"""Rank functions of the port's mesh tests (``tests/test_torch_mesh*.py``).

Each runs on every rank of a :func:`repro_torch.launch.mesh.spawn_mesh`
job, so it lives in a module that imports only the port (the ranks are
spawned and import it by name), and it returns host values.  A case that
raises is reported as ``{"error": traceback}`` in its slot, so one broken
case fails its own test and not the whole job.
"""

import traceback


def config_kw(solve_kw: dict) -> dict:
    """A golden's legacy solve kwargs as SolveConfig fields."""
    kw = dict(solve_kw)
    if "policy_priority" in kw:
        kw["policy"] = "priority" if kw.pop("policy_priority") else "random"
    return kw


def result_dict(r) -> dict:
    """A SolveResult's every deterministic field."""
    d = r.to_dict()
    d.pop("wall_s")
    return d


def _guarded(fn, *args):
    try:
        return fn(*args)
    except Exception:  # a case's failure is its test's, not the job's
        return {"error": traceback.format_exc()}


def _graph(spec: dict):
    from repro_torch.graphs.generators import erdos_renyi

    return erdos_renyi(spec["n"], spec["p"], spec["seed"])


def _solve(problem: str, graph: dict, kw: dict, **solve_kw):
    from repro_torch.api import SolveConfig, SolverSession

    session = SolverSession(problem=problem, config=SolveConfig(use_mesh=True, **kw),
                            device="cpu")
    return result_dict(session.solve(_graph(graph), **solve_kw))


def solve_cases(mesh, cases: list) -> dict:
    """``{label: result dict}`` of ``(label, problem, graph, config kw)``
    solves on the mesh (``use_mesh=True``, the session's path)."""
    return {label: _guarded(_solve, problem, graph, kw)
            for label, problem, graph, kw in cases}


def legacy_solve(mesh, graph: dict, kw: dict) -> dict:
    """The deprecated ``engine.solve`` with ``mesh=`` this rank's mesh:
    the legacy EngineResult's fields."""
    import warnings

    from repro_torch.core import engine as E

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = E.solve(_graph(graph), mesh=mesh, device="cpu", **kw)
    return {k: getattr(r, k) for k in ("best_size", "rounds", "nodes_expanded",
                                       "tasks_transferred", "transfer_rounds",
                                       "transfer_bytes_total", "reduce_sweeps")}


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def refusals(mesh, graph: dict) -> dict:
    """The refusals, raised inside a live group: spill on the mesh and
    ``solve_many`` with ``use_mesh`` (the JAX package's), and a world size
    or a mesh that differs from ``num_workers``."""
    from repro_torch.api import SolveConfig, SolverSession

    g = _graph(graph)
    P = mesh.size

    def session(**kw):
        return SolverSession(config=SolveConfig(**kw), device="cpu")

    return {
        "spill": _refusal(lambda: session(num_workers=P, use_mesh=True,
                                          frontier_spill=True).solve(g)),
        "solve_many": _refusal(lambda: session(num_workers=P, use_mesh=True)
                               .solve_many([g, g])),
        "world_size": _refusal(lambda: session(num_workers=P - 1, use_mesh=True).solve(g)),
        "mesh_size": _refusal(lambda: session(num_workers=P + 1).solve(g, mesh=mesh)),
    }


def durable(mesh, graph: dict, kw: dict, ckpt_dir: str, resume_from: str) -> dict:
    """A mesh solve writing a checkpoint every chunk to ``ckpt_dir``, and a
    mesh solve resumed from a single-process checkpoint ``resume_from``."""
    return {
        "written": _guarded(_solve, "vertex_cover", graph,
                            dict(kw, checkpoint_dir=ckpt_dir, checkpoint_every=1)),
        "resumed": _guarded(_solve, "vertex_cover", graph, dict(kw, resume_from=resume_from)),
    }


def _crashed(graph: dict, kw: dict, at: int) -> dict:
    from repro_torch.faults import FaultEvent, FaultInjector, FaultPlan

    inj = FaultInjector(FaultPlan(events=(FaultEvent("crash", at=at),)))
    return {"result": _solve("vertex_cover", graph, kw, injector=inj),
            "report": inj.report()}


def crashes(mesh, graph: dict, cases: list) -> dict:
    """``{label: {result, report}}`` of one-crash plans on the mesh:
    ``(label, config kw, crash boundary)``."""
    return {label: _guarded(_crashed, graph, kw, at) for label, kw, at in cases}


def job(mesh, parts: list) -> dict:
    """Several of the functions above in one job: ``(name, fn name,
    args)`` each, run in order on every rank."""
    return {name: globals()[fn](mesh, *args) for name, fn, args in parts}


def raise_on_rank(mesh, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises; the others wait in a collective that never
    completes."""
    import torch

    if mesh.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    mesh.all_sum(torch.ones(1, dtype=torch.int32))
    return mesh.rank


def superstep_trajectories(mesh, graph: dict, cases: list, max_steps: int) -> dict:
    """``{label: [(flat state, done), ...]}``: the whole state after the
    startup and after every superstep of ``build_superstep_fn`` on the mesh
    until ``done`` (at most ``max_steps``), gathered from the ranks'
    blocks; ``cases`` are ``(label, knobs)``."""
    from repro_torch.core import engine as E
    from repro_torch.core.superstep import build_superstep_fn, worker_state_to_flat
    from repro_torch.problems.base import make_data
    from repro_torch.problems.registry import get_problem

    spec = get_problem("vertex_cover")
    g = _graph(graph)
    P = mesh.size

    def run(knobs):
        whole = E.make_instance_state(spec, g, P, 4 * g.n + 8, g.W, g.n + 1, "cpu")
        step = build_superstep_fn(spec, make_data(spec, g, "cpu"), num_workers=P,
                                  steps_per_round=4, lanes=1, explore_impl="fused",
                                  mesh=mesh, **knobs)
        block = mesh.shard(whole)
        out = [(worker_state_to_flat(whole), False)]
        for _ in range(max_steps):
            block, done = step(block)
            out.append((worker_state_to_flat(mesh.gather_state(block)), bool(done)))
            if done:
                break
        return out

    return {label: _guarded(run, knobs) for label, knobs in cases}


def chunk_trajectory(mesh, graph: dict, chunk_rounds: int, max_chunks: int) -> list:
    """``[(flat state, done, ran, hot), ...]`` after every call of
    ``build_chunk_fn`` on the mesh until ``done``, gathered from the ranks'
    blocks (``hot`` too)."""
    from repro_torch.core import engine as E
    from repro_torch.core.superstep import build_chunk_fn, worker_state_to_flat
    from repro_torch.problems.base import make_data
    from repro_torch.problems.registry import get_problem

    spec = get_problem("vertex_cover")
    g = _graph(graph)
    P = mesh.size
    chunk = build_chunk_fn(spec, make_data(spec, g, "cpu"), num_workers=P,
                           steps_per_round=4, lanes=1, explore_impl="fused",
                           chunk_rounds=chunk_rounds, mesh=mesh)
    block = mesh.shard(E.make_instance_state(spec, g, P, 4 * g.n + 8, g.W, g.n + 1, "cpu"))
    out = []
    for _ in range(max_chunks):
        block, done, ran, hot = chunk(block)
        out.append((worker_state_to_flat(mesh.gather_state(block)), done, ran,
                    mesh.all_gather(hot.view(1)).numpy()))
        if done:
            break
    return out
