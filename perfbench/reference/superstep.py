"""One superstep of one instance's P workers, written plainly.

The state is a dict of the worker leaves, each leading with the worker axis
P (packed words as int32): ``frontier.masks``/``frontier.sols`` (P, CAP,
W), ``frontier.depths``/``frontier.active`` (P, CAP), ``frontier.overflow``,
``frontier.dropped``, ``best_val``, ``local_best_val``, ``best_sol`` (P, W),
``nodes_expanded``, ``tasks_sent``, ``tasks_recv``, ``rounds``,
``transfer_rounds``, ``payload_words``.  The semantics are the paper's
(§3) as the port documents them:

1. ``steps_per_round`` explore rounds: each worker pops its deepest task
   (the lowest slot among equal depths), expands it, prunes it when its
   bound does not beat the best, takes a terminal value that beats it, and
   pushes the children that can still beat the new best, left then right,
   one deeper, each into its lowest free slot (a push with no free slot is
   dropped and counted);
2. the status of each worker, packed into one word: pending tasks (15 bits)
   and the shallowest pending depth (16 bits, clamped);
3. the best value, the least over the workers, given to every worker;
4. the center (the priority policy): idle workers (nothing pending) in index
   order are matched to donors (two or more pending) ranked by (shallowest
   depth, index); each matched donor sends min(pending - 1, donate_k) of its
   shallowest tasks to its idle worker, which pushes them as in 1.  The
   transfer counters count the records (2W + 1 words each, the sparse
   transfer) of a round that matched anyone;
5. every worker's round counter grows by one; the instance is done when
   nothing is pending.

The result is the state the program's superstep must return, leaf for leaf;
slots that are not active carry no state and are not compared.
"""

from __future__ import annotations

import torch

from perfbench.reference import bits
from perfbench.reference.expand import first

BIG = 1 << 30


def _push(st: dict, masks, sols, depths, valid) -> None:
    """Push K tasks a worker ((P, K, W) words, (P, K) depths and flags), in
    task order, each into the worker's lowest free slot."""
    P, cap = st["frontier.active"].shape
    w = torch.arange(P, device=valid.device)
    for k in range(valid.shape[1]):
        free = ~st["frontier.active"]
        has = free.any(dim=-1)
        slot = first(free).clamp(max=cap - 1)
        put = valid[:, k] & has
        lost = valid[:, k] & ~has
        for name, new in (("frontier.masks", masks[:, k]), ("frontier.sols", sols[:, k])):
            st[name][w, slot] = torch.where(put[:, None], new, st[name][w, slot])
        st["frontier.depths"][w, slot] = torch.where(put, depths[:, k], st["frontier.depths"][w, slot])
        st["frontier.active"][w, slot] |= put
        st["frontier.overflow"] |= lost
        st["frontier.dropped"] += lost.to(torch.int32)


def _pop(st: dict, deepest: bool, limit=None):
    """Pop one task a worker: the deepest (or shallowest), lowest slot
    first; ``limit`` (P,) bool says which workers pop at all.  Returns
    (masks (P, W), sols, depths (P,), valid (P,))."""
    act, dep = st["frontier.active"], st["frontier.depths"]
    P = act.shape[0]
    w = torch.arange(P, device=act.device)
    if deepest:
        d = torch.where(act, dep, -1).amax(dim=-1)
    else:
        d = torch.where(act, dep, BIG).amin(dim=-1)
    slot = first(act & (dep == d[:, None])).clamp(max=act.shape[1] - 1)
    valid = act.any(dim=-1)
    if limit is not None:
        valid = valid & limit
    st["frontier.active"][w, slot] &= ~valid
    return (st["frontier.masks"][w, slot].clone(), st["frontier.sols"][w, slot].clone(),
            dep[w, slot].clone(), valid)


def superstep(expand, A: torch.Tensor, state: dict, knobs: dict) -> tuple:
    """(state after one superstep, done) of one instance whose (1, N, N)
    float64 adjacency is ``A``, by the problem's plain ``expand``.
    ``knobs``: the configuration's engine settings; this follows
    steps_per_round and donate_k as they come, and one task a worker a
    round, packed status words, the priority policy and the sparse transfer
    that skips an empty round, as the configurations state them."""
    followed = {"lanes": 1, "packed_status": True, "policy": "priority",
                "transfer_impl": "sparse", "skip_empty_transfer": True}
    if any(knobs[k] != v for k, v in followed.items()):
        raise ValueError(f"the plain superstep follows {followed}, not {knobs}")
    st = {k: v.clone() for k, v in state.items()}
    P, W = st["best_sol"].shape
    dev = st["best_sol"].device

    for _ in range(knobs["steps_per_round"]):
        masks, sols, depth, valid = _pop(st, deepest=True)
        ex = expand(A, bits.unpack(masks)[None], bits.unpack(sols)[None])
        ex = {k: v[0] for k, v in ex.items()}
        best = st["best_val"]
        live = valid & (ex["bound"] < best)
        term = live & ex["is_terminal"] & (ex["terminal_value"] < best)
        found = torch.where(term, ex["terminal_value"], BIG).to(torch.int32)
        better = found < st["local_best_val"]
        st["best_sol"] = torch.where(better[:, None], bits.pack(ex["terminal_sol"]), st["best_sol"])
        st["local_best_val"] = torch.minimum(st["local_best_val"], found)
        st["best_val"] = torch.minimum(best, found)
        grow = live & ~ex["is_terminal"]
        lv = grow & (ex["left_bound"] < st["best_val"])
        rv = grow & (ex["right_bound"] < st["best_val"])
        _push(st,
              torch.stack([bits.pack(ex["left_mask"]), bits.pack(ex["right_mask"])], 1),
              torch.stack([bits.pack(ex["left_sol"]), bits.pack(ex["right_sol"])], 1),
              torch.stack([depth + 1, depth + 1], 1).to(torch.int32),
              torch.stack([lv, rv], 1))
        st["nodes_expanded"] += valid.to(torch.int32)

    act = st["frontier.active"]
    pending = act.sum(dim=-1).clamp(0, 0x7FFF)
    depth = torch.where(act, st["frontier.depths"], BIG).amin(dim=-1).clamp(0, 0xFFFF)
    gbest = torch.minimum(st["local_best_val"], st["best_val"]).min()
    st["best_val"] = torch.full_like(st["best_val"], int(gbest))

    idx = torch.arange(P, device=dev)
    idle = (pending == 0).nonzero()[:, 0]
    donor_mask = pending >= 2
    key = torch.where(donor_mask, depth.to(torch.int64) * P + idx, 1 << 40)
    donors = torch.argsort(key, stable=True)[: int(donor_mask.sum())]
    n_match = min(idle.numel(), donors.numel())
    k = knobs["donate_k"]
    n_don = torch.zeros(P, dtype=torch.int32, device=dev)
    n_don[donors[:n_match]] = torch.clamp(pending[donors[:n_match]] - 1, max=k).to(torch.int32)
    recv_from = torch.full((P,), -1, dtype=torch.int64, device=dev)
    recv_from[idle[:n_match]] = donors[:n_match]

    blocks = [_pop(st, deepest=False, limit=n_don > j) for j in range(k)]
    src = recv_from.clamp(min=0)
    offered = torch.stack(
        [(recv_from >= 0) & (n_don[src] > j) for j in range(k)], 1)
    _push(st, torch.stack([b[0][src] for b in blocks], 1),
          torch.stack([b[1][src] for b in blocks], 1),
          torch.stack([b[2][src] for b in blocks], 1), offered)

    ran = n_match > 0
    st["tasks_sent"] += n_don
    st["tasks_recv"] += offered.sum(dim=-1, dtype=torch.int32)
    st["transfer_rounds"] += int(ran)
    st["payload_words"] += int(n_don.sum()) * (2 * W + 1)
    st["rounds"] += 1
    return st, not bool(st["frontier.active"].any())


def leaves_differ(ref: dict, got: dict) -> list:
    """The names of the leaves where ``got`` differs from ``ref``; the
    frontier's words and depths are compared on the active slots only."""
    bad = []
    act = ref["frontier.active"]
    for name, a in ref.items():
        b = got[name].to(a.device)
        if name in ("frontier.masks", "frontier.sols", "frontier.depths"):
            same = torch.equal(act, got["frontier.active"].to(a.device)) and torch.equal(a[act], b[act])
        else:
            same = torch.equal(a, b.to(a.dtype))
        if not same:
            bad.append(name)
    return bad
