"""Which ``torch.distributed`` collectives run on CUDA int32 tensors, and
how long each takes: gloo with 4 ranks sharing card 0, NCCL and gloo with 1
rank.  The solver mesh (:mod:`repro_torch.launch.mesh`) carries every
collective on int32 tensors where its workers live; this probe checks that
gloo moves CUDA tensors for each call the mesh makes (and for the list form
of ``all_gather`` beside the one-tensor form), without any host detour in
the caller's code.

Run on a machine with an NVIDIA GPU:

  python -m repro_torch.launch.collective_probe

Each line gives rank 0's results by collective: ``ok`` with the mean ms of
20 synchronised calls (the first collective of a group includes its
set-up) and the value returned, or ``FAIL`` with the error.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, init, backend, q):
    try:
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        res = {}

        def tryit(name, fn):
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(20):
                    out = fn()
                torch.cuda.synchronize()
                res[name] = ("ok", round((time.perf_counter() - t) / 20 * 1e3, 4), str(out)[:80])
            except Exception as e:  # a probe reports every failure and goes on
                res[name] = ("FAIL", repr(e)[:300])

        x = torch.full((1,), rank + 1, dtype=torch.int32, device=dev)

        def ag():
            outs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(outs, x)
            return torch.cat(outs).tolist()

        def ag_big():
            y = torch.full((1, 3, 39), rank, dtype=torch.int32, device=dev)
            outs = [torch.empty_like(y) for _ in range(world)]
            dist.all_gather(outs, y)
            return torch.cat(outs).sum().item()

        def agt():
            out = torch.empty((world,), dtype=torch.int32, device=dev)
            dist.all_gather_into_tensor(out, x)
            return out.tolist()

        def ar(op):
            def f():
                y = x.clone()
                dist.all_reduce(y, op=op)
                return y.tolist()
            return f

        def ar_big():
            y = torch.zeros((world, 3, 39), dtype=torch.int32, device=dev)
            y[rank] = rank
            dist.all_reduce(y)
            return y.sum().item()

        def bar():
            dist.barrier()
            return "ok"

        tryit("all_gather", ag)
        tryit("all_gather_big", ag_big)
        tryit("all_gather_into_tensor", agt)
        tryit("all_reduce_sum", ar(dist.ReduceOp.SUM))
        tryit("all_reduce_min", ar(dist.ReduceOp.MIN))
        tryit("all_reduce_max", ar(dist.ReduceOp.MAX))
        tryit("all_reduce_big", ar_big)
        tryit("barrier", bar)
        dist.destroy_process_group()
        q.put((rank, res))
    except Exception:  # the rank's boundary: hand the traceback to the parent
        q.put((rank, traceback.format_exc()))


def run(backend: str, world: int) -> None:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{d}/rendezvous"
        ps = [ctx.Process(target=_rank, args=(r, world, init, backend, q)) for r in range(world)]
        for p in ps:
            p.start()
        out = {}
        for _ in range(world):
            r, res = q.get(timeout=300)
            out[r] = res
        for p in ps:
            p.join(60)
    print(backend, world, "rank0:", out[0])
    sys.stdout.flush()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the collective probe needs an NVIDIA GPU")
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    sys.stdout.flush()
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    run("gloo", 4)
    run("nccl", 1)
    run("gloo", 1)


if __name__ == "__main__":
    main()
