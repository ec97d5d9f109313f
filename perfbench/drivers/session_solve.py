"""One instance at a time through ``SolverSession.solve``, all workers on it.

The instances of stream 0 (``instances.py``) are solved one after another,
each with the superstep budget ``deadline_supersteps`` (the solve's
``max_rounds``: an anytime answer after it), the next one started when the
last returns.  ``workers`` replaces the configuration's workers an instance.
Set-up is the first solve's start and its first chunk, which builds every
kernel the cell uses; the window runs whole chunks until ``seconds`` have
passed (and at least two, so that chunk ``observe.TRACE_CHUNK`` ran), and
the solve in hand is then stopped at its chunk boundary, where its anytime
answer is read.  Nodes accrue chunk by chunk, with no bursts, so the
window's end may follow the clock.

What the run observes, from outside the program: each chunk's wall and
supersteps (a :class:`PlaneCache` whose solo plane is timed), the solver's
own per-worker ``nodes_expanded`` at the window's first and last chunk
boundary and in each result returned between them, the sampled launches
and superstep of ``observe.Hooks``, and with ``--trace 1`` a profile of
the same chunk.
"""

from __future__ import annotations

import time

import torch

from perfbench import instances, observe


class _Closed(Exception):
    """The window closed at a chunk boundary; carries the solve's state."""

    def __init__(self, state, rounds):
        super().__init__("window closed")
        self.state, self.rounds = state, rounds


def run(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    marks = [("driver", time.perf_counter())]
    from repro_torch.api import PlaneCache, SolveConfig, SolverSession
    from repro_torch.core import engine
    from repro_torch.core.superstep import map_state
    from repro_torch.graphs.bitgraph import BitGraph
    from repro_torch.problems.registry import get_problem

    dev = torch.device(device)
    spec = get_problem(config["problem"])
    cfg = SolveConfig(**{**config["engine"], "num_workers": int(traffic["workers"])},
                      max_rounds=int(traffic["deadline_supersteps"]))
    marks.append(("import", time.perf_counter()))
    pool = instances.pool(config["graph"], traffic["pool_seed"], traffic["pool"])
    graphs = [BitGraph.from_dense(d) for d in pool]
    marks.append(("pool", time.perf_counter()))
    hooks = observe.Hooks(seed, cfg)
    prof = observe.Profile(dev) if trace else None
    chunks = []
    w = {"chunk": None, "t0": None, "nodes0": 0, "ticket": 0, "rounds": 0}

    class TimedCache(PlaneCache):
        def solo_plane(self, *a):
            plane = super().solo_plane(*a)

            def timed(data, state, *rest, **kw):
                c = w["chunk"]
                sampled = c == observe.TRACE_CHUNK
                hooks.lane_tickets = [w["ticket"]]
                hooks.armed = sampled
                if sampled and prof is not None:
                    prof.start()
                t = time.perf_counter()
                out = plane(data, state, *rest, **kw)
                wall = time.perf_counter() - t
                hooks.armed = False
                if sampled and prof is not None:
                    prof.stop()
                chunks.append({"wall": wall, "ran": out[2], "busy": out[2], "lanes": 1,
                               "step": c, "traced": sampled and prof is not None})
                w["rounds"] += out[2]
                if c is None:  # the warm chunk: the window opens at its end
                    w["t0"] = time.perf_counter()
                    w["nodes0"] = int(out[0].nodes_expanded.sum())
                    w["chunk"] = 0
                else:
                    w["chunk"] = c + 1
                    paused = prof.paused if prof is not None else 0.0
                    if (time.perf_counter() - w["t0"] - paused >= seconds
                            and w["chunk"] > observe.TRACE_CHUNK and not out[1]):
                        raise _Closed(out[0], w["rounds"])
                return out

            return timed

    answers, owner, nodes = [], {}, 0
    with observe.installed(config, hooks):
        session = SolverSession(spec, config=cfg, device=dev, cache=TimedCache())
        marks.append(("session", time.perf_counter()))
        k = 0
        while True:
            i = instances.stream(0, k, 1, len(pool))
            owner[k], w["ticket"], w["rounds"] = i, k, 0
            try:
                r = session.solve(graphs[i])
            except _Closed as closed:
                t_w1 = time.perf_counter() - (prof.paused if prof is not None else 0.0)
                state = closed.state
                host = engine._fetch_batch_state(map_state(lambda x: x[None], state))
                nodes += int(state.nodes_expanded.sum()) - (w["nodes0"] if k == 0 else 0)
                answers.append(dict(observe.answer(engine, host, 0, spec, graphs[i],
                                                   closed.rounds, cfg), pool=i))
                break
            nodes += r.nodes_expanded - (w["nodes0"] if k == 0 else 0)
            answers.append({
                "pool": i, "size": r.best_size,
                "words": None if r.best_sol is None else r.best_sol,
                "exact": bool(r.found and r.rounds < cfg.max_rounds),
                "found": bool(r.found), "retired": True,
            })
            k += 1
        peak = observe.peak_bytes(dev)
        del session, state, host

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks.insert(-1, ("warm chunk", w["t0"]))
    return {
        **hooks.obs(),
        "problem": config["problem"],
        "setup_s": w["t0"] - t_start,
        "setup_marks": [(name, t - t_start) for name, t in sorted(marks, key=lambda m: m[1])],
        "window_s": t_w1 - w["t0"],
        "nodes": nodes,
        "answers": answers,
        "pool": pool,
        "owner": owner,
        "chunks": [c for c in chunks if c["step"] is not None],
        "steps_per_round": cfg.steps_per_round,
        "admissions": [],
        "memory_peak_bytes": peak,
        "trace": prof.summary() if prof is not None else None,
        "engine": observe.knobs(cfg),
        "kernel": config["kernel_entry"].split(":")[1],
    }
