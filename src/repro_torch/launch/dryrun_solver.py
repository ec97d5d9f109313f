"""The paper's own technique at scale: the superstep's collective bytes.

The port of ``repro/launch/dryrun_solver.py``.  JAX lowers the SPMD
superstep with one worker per device on a 512-device mesh and reads its
collectives from the HLO; the port has no compiler IR, so it RUNS one
superstep with one worker a rank and counts the collectives its mesh
issues (``SolverMesh.coll_bytes``/``coll_counts``), in the convention of
:func:`repro_torch.launch.analysis.collective_bytes` (result bytes, an
all-reduce's ×2, by kind, with counts), per rank.  The same four control
planes: the baseline (3-int status rows, unconditional record all-gather),
the packed status word (+ a ``pmin`` of the best value), the data plane
skipped on match-free rounds, and the sparse data plane (a masked sum of
the matched records).

Two meshes run it, on the card unless ``--device cpu`` asks for the CPU
(without CUDA, the default raises):

* a real group (``--ranks real``): ``spawn_mesh``, gloo on the CPU, the
  fused ``vc_expand`` exploring on the card;
* a dry stand-in (``--ranks dry``, default): :class:`DrySolverMesh`, one
  rank of a mesh of any size in one process, which issues no communication
  and counts shapes (its all-gathers hold zeros for the other ranks: idle
  peers).  It reports JAX's default (n 1024, 512 workers) without 512
  processes, and equals the real group wherever the same collectives run
  (the test holds them equal at 4 ranks).

JAX's static count includes both branches of the skip's ``lax.cond``, so
the reported superstep is the first one whose data plane ran (a matched
round), at most ``MAX_SUPERSTEPS`` in; a variant whose supersteps found no
match in that many is reported with ``data_plane: false``, not as 0 bytes.
The bytes do not depend on the explore rounds a superstep; at JAX's 32 the
first superstep of G(64) on 4 ranks finishes the solve before any round
has a match, so the twin explores ``STEPS_PER_ROUND``.
``--chunked`` counts one call of the chunk runner (``--chunk-rounds``
supersteps at most; it ends early on quiescence, so the count depends on
the data: ``supersteps_in_chunk``): JAX's mesh chunk does not lower on
jax 0.9.0 (ROADMAP §3), so it has no JAX oracle.  No FLOP or
temp-memory terms: those come from XLA's compiled module in JAX.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_solver [--n 1024] [--workers 512]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_solver --n 64 --workers 4 --ranks real
  PYTHONPATH=src python -m repro_torch.launch.dryrun_solver --device cpu
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.api.session import resolve_device
from repro_torch.launch.analysis import roofline

VARIANTS = [
    # (packed_status, skip_empty_transfer, transfer_impl, label): JAX's four
    (False, False, "gather", "baseline (3-int status, unconditional gather)"),
    (True, False, "gather", "packed status word"),
    (True, True, "gather", "packed + skip-empty-transfer"),
    (True, True, "sparse", "packed + skip-empty + sparse psum transfer"),
]
# explore rounds a superstep: at JAX's 32 the first superstep of G(64) on 4
# ranks ends the solve before a round has a match; the bytes do not depend
# on it
STEPS_PER_ROUND = 2
# supersteps run looking for the first matched round (a data plane that ran)
MAX_SUPERSTEPS = 8


def count_engine(mesh, n: int, *, packed_status, skip_empty_transfer, transfer_impl="gather",
                 chunked=False, chunk_rounds=16) -> dict:
    """One rank's collectives of one superstep (or chunk) of vertex cover on
    G(n, 4/(n-1), seed 0) over ``mesh`` (one worker a rank), JAX's
    ``lower_engine`` shapes: capacity 4n + 8, W = n_words(n), one lane."""
    from repro_torch.core import engine as E
    from repro_torch.core.frontier import Frontier
    from repro_torch.core.superstep import build_chunk_fn, build_superstep_fn
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.problems.base import make_data
    from repro_torch.problems.registry import get_problem

    P = mesh.size
    g = erdos_renyi(n, 4.0 / (n - 1), 0)
    spec = get_problem("vertex_cover")
    data = make_data(spec, g, mesh.device)
    cap = 4 * n + 8
    kwargs = dict(num_workers=P, steps_per_round=STEPS_PER_ROUND, lanes=1,
                  packed_status=packed_status,
                  skip_empty_transfer=skip_empty_transfer, transfer_impl=transfer_impl,
                  explore_impl="fused", mesh=mesh)
    ran_in_chunk = []
    if chunked:
        chunk = build_chunk_fn(spec, data, chunk_rounds=chunk_rounds, **kwargs)

        def fn(s):
            s, done, ran, _ = chunk(s)
            ran_in_chunk.append(int(ran))
            return s, done
    else:
        fn = build_superstep_fn(spec, data, **kwargs)
    # every task starts on rank 0 (a 1-worker startup) and the other ranks
    # idle, so the first superstep has work to share on a real group as on
    # the stand-in, whose peers read as idle (a startup scattered over P
    # workers keeps all of them busy for hundreds of supersteps at n 600)
    whole = E.make_instance_state(spec, g, P, cap, g.W, n + 1, "cpu")
    one = E.make_instance_state(spec, g, 1, cap, g.W, n + 1, "cpu").frontier
    whole = whole._replace(frontier=Frontier(
        *[torch.cat([a, torch.zeros_like(b[1:])]) for a, b in zip(one, whole.frontier)]))
    block = mesh.shard(whole)
    ran, step = False, 0
    for step in range(1, MAX_SUPERSTEPS + 1):
        mesh.reset_collectives()
        before = block.transfer_rounds.clone()
        block, done = fn(block)
        ran = bool((block.transfer_rounds != before).any()) if not chunked else True
        if ran or bool(done):
            break
    coll = mesh.collective_report()
    return {
        "n": n,
        "workers": P,
        "packed_status": packed_status,
        "skip_empty_transfer": skip_empty_transfer,
        "transfer_impl": transfer_impl,
        "chunked": chunked,
        "superstep": step,
        "supersteps_in_chunk": ran_in_chunk[-1] if chunked else None,
        "data_plane": ran,
        "mesh": "dry" if mesh.backend == "none" else mesh.backend,
        "collectives": {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": coll["counts"],
        "roofline": roofline(0.0, 0.0, coll["total"]),
    }


def count_variants(mesh, n: int, **kw) -> list:
    """``count_engine`` for JAX's four labelled variants on ``mesh``."""
    out = []
    for packed, skip, impl, label in VARIANTS:
        r = count_engine(mesh, n, packed_status=packed, skip_empty_transfer=skip,
                         transfer_impl=impl, **kw)
        r["label"] = label
        out.append(r)
    return out


def dry_variants(n: int, workers: int, device=None, **kw) -> list:
    """The four variants on a dry stand-in of a ``workers``-rank mesh (rank
    0 on ``device``: the card unless the caller asks for the CPU): no
    process group, no communication."""
    from repro_torch.launch.mesh import DrySolverMesh

    return count_variants(DrySolverMesh(workers, device=resolve_device(device)), n, **kw)


def real_variants(mesh, n: int, kw: dict) -> list:
    """A ``spawn_mesh`` rank function: the four variants on the real group."""
    return count_variants(mesh, n, **kw)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=512)
    ap.add_argument("--ranks", default="dry", choices=["dry", "real"],
                    help="a dry stand-in in this process, or a real group of --workers "
                         "ranks (spawn_mesh)")
    ap.add_argument("--device", default=None,
                    help="where the supersteps run: the card (default) or cpu")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chunked", action="store_true",
                    help="count one call of the K-round chunk runner")
    ap.add_argument("--chunk-rounds", type=int, default=16)
    args = ap.parse_args(argv)
    kw = dict(chunked=args.chunked, chunk_rounds=args.chunk_rounds)
    device = resolve_device(args.device)
    if args.ranks == "dry":
        with torch.inference_mode():
            results = dry_variants(args.n, args.workers, device, **kw)
    else:
        from repro_torch.launch.mesh import spawn_mesh

        ranks = spawn_mesh(real_variants, args.workers, device=device,
                           args=(args.n, kw))
        if any(r != ranks[0] for r in ranks[1:]):
            raise RuntimeError("the ranks counted different collectives")
        results = ranks[0]
    for r in results:
        c = r["collectives"]
        plane = "" if r["data_plane"] else " (no matched round: data plane not run)"
        print(f"{r['label']:>50s}: coll_total={c['total']}B "
              f"(ag={c['all-gather']} ar={c['all-reduce']}) "
              f"counts={r['collective_counts']} superstep={r['superstep']} "
              f"mesh={r['mesh']}{plane}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
