"""``correct`` for the branch-and-bound solver's cells: what the window
produced against the plain reference of the configuration's problem.

The problem's plain module is ``reference/problems/<problem>.py``, found by
name.  The numbers compared, each a count with the limit 0:

* ``answers_infeasible``: answers (every ticket retired in the window and
  the anytime answer of every lane still solving at the close) whose
  solution does not hold what the answer says;
* ``answers_not_optimal``, where the configuration has its optimum
  checked: claimed optima that are not the problem's ``optimum``;
* ``kernel_rows_differ``: task rows of the sampled expansion launches
  whose outputs differ from the plain ``expand`` on the launch's own inputs;
* ``superstep_leaves_differ``: leaves of the sampled superstep of one lane
  that differ from the plain superstep run from the lane's state before it,
  and ``lanes_not_stepped``: live lanes of that superstep whose every
  worker did not advance one round and expand a node;
* ``samples_missing``: sampled launches or supersteps the window never
  reached.
"""

from __future__ import annotations

from pathlib import Path

import torch

from perfbench.reference import bits
from perfbench.reference import expand as ref_expand
from perfbench.reference import superstep as ref_superstep


def _adjacency(ref, obs: dict, tickets: list, W: int, device):
    graph = getattr(ref, "adjacency", lambda dense: dense)
    dense = [None if t is None else graph(obs["pool"][obs["owner"][t]]) for t in tickets]
    return bits.padded_adjacency(dense, W, device)


def _answers(ref, config: dict, obs: dict) -> tuple:
    """(infeasible, not optimal) over every answer; an answer with nothing
    found is a failure, not a wrong answer."""
    checked = config["guarantees"]["optimum_checked"]
    infeasible = not_optimal = 0
    for a in obs["answers"]:
        if a["words"] is None:
            continue
        dense = obs["pool"][a["pool"]]
        if ref.infeasible(dense, a["size"], a["words"]):
            infeasible += 1
        elif checked and a["exact"]:
            not_optimal += int(a["size"] != ref.optimum(dense))
    return infeasible, not_optimal


def judge(config: dict, obs: dict, device, root: Path) -> tuple:
    """(checks, attempted, failed).  ``checks`` maps each number compared to
    ``(value, limit)``; ``attempted`` counts every answer judged, ``failed``
    the retired ones with nothing found or, where the budget is a limit,
    stopped by it.  Fills ``obs["sampled"]`` with each sampled launch's
    shape and plain work, for the rooflines."""
    from perfbench.bench import find

    ref = find(root, "reference/problems", config["problem"])
    checks = {}
    infeasible, not_optimal = _answers(ref, config, obs)
    checks["answers_infeasible"] = (infeasible, 0)
    if config["guarantees"]["optimum_checked"]:
        checks["answers_not_optimal"] = (not_optimal, 0)

    differ, obs["sampled"] = 0, {}
    for index, cap in sorted(obs["launches"].items()):
        B, W = cap["B"], cap["W"]
        T = cap["masks"].shape[0]
        R, N = T // B, 32 * W
        A = _adjacency(ref, obs, cap["tickets"], W, device)
        out = ref.expand(A, bits.unpack(cap["masks"].to(device)).view(B, R, N),
                         bits.unpack(cap["sols"].to(device)).view(B, R, N))
        got = {k: (bits.unpack(v.to(device)).view(B, R, N) if v.dim() == 2 else
                   v.to(device).view(B, R))
               for k, v in cap["out"].items()}
        occupied = torch.tensor([t is not None for t in cap["tickets"]], device=device)
        differ += int((ref_expand.rows_differ(out, got) & occupied[:, None]).sum())
        obs["sampled"][index] = {"B": B, "n": cap["n"], "W": W, "T": T,
                                 "in_mask": int(out["in_mask"][occupied].sum())}
    checks["kernel_rows_differ"] = (differ, 0)

    cap = obs["superstep"]
    missing = obs["launches_planned"] - len(obs["launches"])
    if cap is None or cap["lane"] is None:
        missing += 1
    else:
        W = cap["before"]["best_sol"].shape[-1]
        A = _adjacency(ref, obs, [cap["ticket"]], W, device)
        before = {k: v.to(device) for k, v in cap["before"].items()}
        after, done = ref_superstep.superstep(ref.expand, A, before, obs["engine"])
        bad = ref_superstep.leaves_differ(after, cap["after"])
        checks["superstep_leaves_differ"] = (len(bad) + int(done != cap["done"]), 0)
        P = cap["P"]
        (r0, r1), (n0, n1) = cap["rounds"], cap["nodes"]
        stepped = ((r1 - r0).view(-1, P) == 1).all(-1) & (
            n1.view(-1, P).sum(-1) > n0.view(-1, P).sum(-1))
        live = torch.as_tensor(cap["live_lanes"], dtype=torch.long)
        checks["lanes_not_stepped"] = (int((~stepped.cpu()[live]).sum()), 0)
    checks["samples_missing"] = (missing, 0)

    budget_fails = config["guarantees"]["budget_is_failure"]
    failed = sum(1 for a in obs["answers"]
                 if a["retired"] and (not a["found"] or (budget_fails and not a["exact"])))
    return checks, len(obs["answers"]), failed
