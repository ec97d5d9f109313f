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


def moe_ep(mesh, cases: list) -> dict:
    """``{label: [per rank (data rank, model rank, out, aux)]}``: the
    expert-parallel MoE layer (``moe_apply_ep``) of block 0 on each case's
    (data D, model M) grid of the job's D·M ranks; a case is ``(label, cfg,
    tree, x, (D, M))`` with ``tree`` the model's JAX tree (a rank loads its
    experts' cut of it, ``expert_shard``) and ``x`` (B, S, d) the whole
    batch (a data rank takes its rows)."""
    import torch

    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.models.convert import expert_shard, load_jax_params
    from repro_torch.models.moe import expert_range, moe_apply_ep
    from repro_torch.models.transformer import init_lm

    torch.set_num_threads(1)

    def run(cfg, tree, x, grid):
        D, M = grid
        ep = make_expert_mesh(D, M, device="cpu")
        m = ep.model.rank
        lm = init_lm(cfg, device="cpu", experts=expert_range(cfg.n_experts, m, M))
        p = load_jax_params(lm, expert_shard(tree, m, M)).blocks[0].moe
        B = x.shape[0]
        xs = torch.from_numpy(x[ep.data.rank * (B // D):(ep.data.rank + 1) * (B // D)])
        with torch.no_grad():
            out, aux = moe_apply_ep(cfg, p, xs, ep)
        return (ep.data.rank, ep.model.rank, out.numpy(), float(aux),
                ep.collective_report())

    return {label: _guarded(run, cfg, tree, x, grid) for label, cfg, tree, x, grid in cases}


def serve_ep(mesh, spec: dict) -> dict:
    """``launch.serve_lm.serve_expert_parallel`` on one thread a rank."""
    import torch

    from repro_torch.launch.serve_lm import serve_expert_parallel

    torch.set_num_threads(1)
    return serve_expert_parallel(mesh, spec)


def _flat_np(tree, prefix="") -> dict:
    """{path: numpy leaf} of a JAX-layout tree of tensors."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy().copy()
    return out


def _ep_params(cfg, tree, grid):
    """This rank's (ExpertMesh, model, params): the grid's rank with its
    experts' cut of ``tree``."""
    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.models.convert import expert_shard, load_jax_params
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import init_expert_parallel

    ep = make_expert_mesh(*grid, device="cpu")
    params = init_expert_parallel(cfg, ep, device="cpu")
    load_jax_params(params, expert_shard(tree, ep.model.rank, ep.model.size))
    return ep, get_model(cfg), params


def _rows(batch: dict, ep) -> dict:
    import torch

    D, d = ep.data.size, ep.data.rank
    B = next(iter(batch.values())).shape[0]
    return {k: torch.from_numpy(v[d * B // D:(d + 1) * B // D]) for k, v in batch.items()}


def moe_ep_train(mesh, cases: list) -> dict:
    """``{label: this rank's readings}`` of expert-parallel training on each
    case's (data D, model M) grid; a case is ``(label, cfg, tree, batch,
    (D, M))`` with ``tree`` the model's JAX tree and ``batch`` the global
    batch (numpy).  Readings: the rank's place, ``value_and_grad``'s loss
    and gradients (JAX layout, the expert leaves this rank's shards), then
    two ``train_step`` from a fresh AdamW state: their losses and grad
    norms, the parameters after the first and after the second."""
    import torch

    from repro_torch.launch.train import train_step, value_and_grad
    from repro_torch.models.convert import export_params, export_tree
    from repro_torch.optim import adamw_init

    torch.set_num_threads(1)

    def run(cfg, tree, batch, grid):
        ep, model, params = _ep_params(cfg, tree, grid)
        b = _rows(batch, ep)
        loss, grads = value_and_grad(model, params, b)
        out = {"d": ep.data.rank, "m": ep.model.rank, "loss": float(loss),
               "grads": _flat_np(export_tree(params, grads)), "steps": []}
        opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
        for _ in range(2):
            opt, loss, gnorm = train_step(model, params, opt, b, peak_lr=3e-4,
                                          total_steps=10_000)
            out["steps"].append({"loss": float(loss), "gnorm": float(gnorm),
                                 "params": _flat_np(export_params(params))})
        return out

    return {label: _guarded(run, cfg, tree, batch, grid)
            for label, cfg, tree, batch, grid in cases}


def moe_ep_layer_grad(mesh, cases: list) -> dict:
    """``{label: (data rank, model rank, dL/dx of its rows, dL/drouter)}``:
    one MoE layer (block 0 of ``tree``) on each case's grid, the rank's loss
    ``D · sum(out · w) + aux`` over its rows (its share of the global
    ``sum(out · w) + aux``, scaled as a data rank's mean loss is); a case is
    ``(label, cfg, tree, x, w, (D, M))``, ``x`` and ``w`` (B, S, d)."""
    import torch

    from repro_torch.models.moe import moe_apply_ep

    torch.set_num_threads(1)

    def run(cfg, tree, x, w, grid):
        ep, _, params = _ep_params(cfg, tree, grid)
        p = params.blocks[0].moe
        r = _rows({"x": x, "w": w}, ep)
        xs = r["x"].requires_grad_(True)
        out, aux = moe_apply_ep(cfg, p, xs, ep)
        loss = ep.data.size * torch.sum(out * r["w"]) + aux
        gx, gr = torch.autograd.grad(loss, (xs, p.router))
        return ep.data.rank, ep.model.rank, gx.numpy(), gr.numpy()

    return {label: _guarded(run, cfg, tree, x, w, grid)
            for label, cfg, tree, x, w, grid in cases}


def ep_train_checkpoints(mesh, spec: dict) -> dict:
    """Checkpoints across the grid and one process: ``train_loop`` on the
    spec's grid to ``first`` steps, checkpointed in ``write_dir``; then a
    fresh run on the grid resumed from ``resume_dir`` (written by one
    process) to ``steps``.  -> the rank's place and both runs' losses."""
    import torch

    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.launch.train import train_loop

    torch.set_num_threads(1)
    ep = make_expert_mesh(*spec["grid"], device="cpu")
    kw = dict(spec["loop"], device="cpu", ep=ep, ckpt_every=10**9)
    _, _, written = train_loop(spec["cfg"], steps=spec["first"], ckpt_dir=spec["write_dir"],
                               **kw)
    _, opt, resumed = train_loop(spec["cfg"], steps=spec["steps"],
                                 ckpt_dir=spec["resume_dir"], resume=True, **kw)
    return {"d": ep.data.rank, "m": ep.model.rank, "written": written, "resumed": resumed,
            "step": int(opt.step)}


def ep_train_loop(mesh, spec: dict) -> dict:
    """``train_loop`` on the spec's (D, M) grid from the seeded init, as
    ``launch.train``'s ranks run it: -> the grid, each step's loss and
    grad norm."""
    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.launch.train import train_loop

    ep = make_expert_mesh(*spec["grid"], device="cpu")
    gnorms = []
    _, _, losses = train_loop(spec["cfg"], **spec["loop"], device="cpu", ep=ep, gnorms=gnorms)
    return {"grid": [ep.data.size, ep.model.size], "losses": losses, "gnorms": gnorms}


def spans_of_solve(mesh, graph: dict, kw: dict) -> dict:
    """A vertex-cover solve on the mesh under ``telemetry.recording()``: its
    result and the (name, parent) pairs of the spans this rank recorded."""
    from repro_torch import telemetry

    telemetry.clear()
    with telemetry.recording():
        r = _solve("vertex_cover", graph, kw)
    return {"result": r, "spans": sorted({(s.name, s.parent) for s in telemetry.spans()})}
