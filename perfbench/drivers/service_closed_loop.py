"""A closed loop of clients over ``SolveService.submit``/``step``.

Each of ``clients`` clients keeps one request outstanding: it submits the
next instance of its stream (``instances.py``) when its last one retires.
Every request carries the superstep budget ``deadline_supersteps`` (an
anytime answer after it).  In set-up the clients join in ``join_steps``
equal groups, one group a service step (its admissions and one chunk; the
first builds every kernel the cell uses).  Instances of one family take
nearly the same number of supersteps, so clients that all joined at once
would finish in waves; joining over about one solve's length spreads their
phases, and the window sees completions at a steady rate.

The window is a fixed number of whole service steps (admissions, one chunk,
retirements): ``round(seconds / step_s)``, and at least two, ``step_s``
being the traffic's nominal wall of one step on an H100.  So a seed's
window does the same work on every run, and a rate does not move with the
step at which a timed window would close: completions come a chunk at a
time, in bursts.

What the run observes, all from outside the program:

* each chunk's wall and supersteps (a :class:`PlaneCache` whose plane is
  timed; a chunk ends in the plane's own read of ``done``), its lanes'
  busy supersteps, and the ticket in each lane;
* each admission's wall, with a synchronize (a :class:`SolveService` whose
  ``_admit_into`` is timed);
* the solver's own node counters: every lane's per-worker
  ``nodes_expanded`` at the window's first and last chunk boundary, and the
  ``nodes_expanded`` of each ticket retired between them;
* the sampled launches and superstep of ``observe.Hooks``, and with
  ``--trace 1`` a profile of the same step, ``observe.TRACE_CHUNK``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import instances, observe


def run(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    marks = [("driver", time.perf_counter())]
    from repro_torch.api import PlaneCache, SolveConfig, SolveService
    from repro_torch.core import engine
    from repro_torch.graphs.bitgraph import BitGraph
    from repro_torch.problems.registry import get_problem

    dev = torch.device(device)
    spec = get_problem(config["problem"])
    cfg = SolveConfig(**config["engine"], service_lanes=traffic["lanes"])
    steps = max(observe.TRACE_CHUNK + 1, round(seconds / traffic["step_s"]))
    marks.append(("import", time.perf_counter()))
    pool = instances.pool(config["graph"], traffic["pool_seed"], traffic["pool"])
    graphs = [BitGraph.from_dense(d) for d in pool]
    marks.append(("pool", time.perf_counter()))
    hooks = observe.Hooks(seed, cfg)
    chunks = []  # per plane call: its wall, supersteps, busy lane-supersteps, step
    admissions = []  # (seconds, step index or None in set-up)
    at = {"step": None}

    class TimedCache(PlaneCache):
        def batch_plane(self, *a):
            plane = super().batch_plane(*a)

            def timed(datas, worker, done, *rest, **kw):
                hooks.lane_tickets = [None if r is None else r.ticket
                                      for r in live_plane().requests]
                sampled = at["step"] == observe.TRACE_CHUNK
                hooks.armed = sampled
                t = time.perf_counter()
                out = plane(datas, worker, done, *rest, **kw)
                wall = time.perf_counter() - t
                hooks.armed = False
                chunks.append({"wall": wall, "ran": out[3], "busy": int(out[2].sum()),
                               "lanes": len(hooks.lane_tickets), "step": at["step"],
                               "traced": sampled and trace})
                return out

            return timed

    class TimedService(SolveService):
        def _admit_into(self, *a):
            t = time.perf_counter()
            super()._admit_into(*a)
            observe.sync(dev)
            admissions.append((time.perf_counter() - t, at["step"]))

    with observe.installed(config, hooks):
        svc = TimedService(config["problem"], cfg, device=dev, cache=TimedCache())

        def live_plane():
            return next(iter(svc._planes.values()))

        budget = int(traffic["deadline_supersteps"])
        clients, groups = int(traffic["clients"]), int(traffic["join_steps"])
        owner, client_of, sent = {}, {}, [0] * clients  # ticket -> pool index, client

        def submit(c):
            i = instances.stream(c, sent[c], clients, len(pool))
            t = svc.submit(graphs[i], deadline=budget)
            owner[t], client_of[t] = i, c
            sent[c] += 1

        marks.append(("service", time.perf_counter()))
        rank = np.argsort(instances.order(seed, clients))  # each client's place in line
        for g in range(groups):
            for c in sorted(range(clients * g // groups, clients * (g + 1) // groups),
                            key=lambda c: rank[c]):
                submit(c)
            for t in svc.step():
                svc.result(t)
                submit(client_of[t])
        observe.sync(dev)
        marks.append(("warm steps", time.perf_counter()))

        def lane_nodes():
            plane = live_plane()
            per_lane = plane.lanes.worker.nodes_expanded.sum(-1).cpu().numpy()
            return {r.ticket: int(per_lane[b]) for b, r in enumerate(plane.requests)
                    if r is not None}

        t_w0 = time.perf_counter()
        nodes_start = lane_nodes()
        answers, retired_nodes = [], {}
        prof = observe.Profile(dev) if trace else None
        for step in range(steps):
            at["step"] = step
            if prof is not None and step == observe.TRACE_CHUNK:
                prof.start()
            done = svc.step()
            if prof is not None and step == observe.TRACE_CHUNK:
                prof.stop()
            for t in done:
                r = svc.result(t)
                retired_nodes[t] = r.nodes_expanded
                answers.append({
                    "pool": owner[t], "size": r.best_size,
                    "words": None if r.best_sol is None else np.asarray(r.best_sol, np.uint32),
                    "exact": bool(r.found and not r.stats.service.deadline_hit),
                    "found": bool(r.found), "retired": True,
                })
                submit(client_of[t])
        t_w1 = time.perf_counter() - (prof.paused if prof is not None else 0.0)
        nodes_end = lane_nodes()

        # the anytime answer of every lane still solving at the close
        plane = live_plane()
        host = engine._fetch_batch_state(plane.lanes.worker)
        rounds = plane.lanes.rounds.cpu().numpy()
        for b, req in enumerate(plane.requests):
            if req is not None:
                answers.append(dict(observe.answer(engine, host, b, spec, req.g,
                                                   int(rounds[b]), cfg, req.k),
                                    pool=owner[req.ticket]))
        peak = observe.peak_bytes(dev)
        del svc, plane, host

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # every ticket live at the window's start is live at its end or retired
    # in it, so this counts each ticket's nodes expanded inside the window
    nodes = (sum(nodes_end.values()) + sum(retired_nodes.values())
             - sum(nodes_start.values()))
    return {
        **hooks.obs(),
        "problem": config["problem"],
        "setup_s": t_w0 - t_start,
        "setup_marks": [(name, t - t_start) for name, t in marks],
        "window_s": t_w1 - t_w0,
        "nodes": nodes,
        "answers": answers,
        "pool": pool,
        "owner": owner,
        "chunks": [c for c in chunks if c["step"] is not None],
        "steps_per_round": cfg.steps_per_round,
        "admissions": [a for a, s in admissions if s is not None],
        "memory_peak_bytes": peak,
        "trace": prof.summary() if prof is not None else None,
        "engine": observe.knobs(cfg),
        "kernel": config["kernel_entry"].split(":")[1],
    }
