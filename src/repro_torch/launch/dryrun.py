"""Dry run of every (arch x shape) cell on one H100: counted, not compiled.

The port of ``repro/launch/dryrun.py``.  For each cell it builds the REAL
step with no weights: ``Model.init(device="meta")`` (shapes and dtypes, no
storage), then for ``train`` the loss, its backward (the per-block remat's
recompute included, as JAX's HLO count includes it) and the AdamW update
(``launch/train.py``'s ``train_step``), for ``prefill`` ``Model.forward``,
for ``decode`` ``init_decode_cache`` + one ``decode_fn`` token against a
``seq_len``-deep cache.  Running it on ``meta`` tensors executes every aten
op without data, so nothing needs a card and nothing is allocated:

* ``flops``: the matrix products ``torch.utils.flop_counter.FlopCounterMode``
  counts (mm, bmm, addmm and the like; attention's products through the
  plain version's meta route, masked pairs included), plus ``wkv6``'s
  recurrence by formula (:mod:`repro_torch.kernels.meta`).  Elementwise work
  is not counted (XLA's cost analysis counts it too);
* ``bytes_accessed``: the sum of every aten op's input and output bytes
  (views excluded; a kernel's meta route counts its own inputs and outputs
  once).  An upper bound: no fusion, every intermediate written and read;
* ``argument_size_b``: parameters, optimizer state, batch and cache, exact
  from the meta tensors;
* ``peak_estimate_b``: the arguments plus the largest sum of live storage
  bytes the pass held (each op's outputs alive until their last reference
  dies), against the card's memory (``fits``):
  ``torch.cuda.get_device_properties(0).total_memory`` where a card is
  present, else 80 GiB, stated in the result.

The roofline terms divide these counts by the H100's rates
(:mod:`repro_torch.launch.analysis`): host counts over the card's constants,
not measurements.  No depth extrapolation is needed (JAX's
``_reduced_depths``, which exists because XLA counts a while body once):
eager counting sees every layer.  The cells are JAX's, sized for a pod,
here on one card: most do not fit, and the report says so.

Out of scope (the port has no compiler IR and one card): the HLO
collective parse, XLA's ``memory_analysis``, the production mesh
(``--mesh``) and the sharding-rule overrides (``--set``).  ``--moe-impl
shard_map --expert-ranks M`` sizes one rank of the expert-parallel route
(:func:`repro_torch.models.moe.moe_apply_ep`) on a (1, M) grid in an MoE
arch's cells: its E/M experts, its collectives counted by a stand-in that
issues none.  A ``train`` cell counts the expert-parallel ``train_step``:
the forward's collectives, the remat recompute's, the backward's (the
input's and the router's sums over the model ranks) and the global norm's
sum of the expert shards' squares.  As in JAX, where it is a rule override,
an arch without experts ignores it (its one-card cell).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_h100.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b \\
      --shape prefill_32k --moe-impl shard_map --expert-ranks 4
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.kernels import meta
from repro_torch.launch.analysis import (
    CARD_BYTES_DEFAULT,
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    collective_bytes,
    model_flops,
    roofline,
)
from repro_torch.launch.train import train_step
from repro_torch.models import layers as L
from repro_torch.models.registry import Model, get_model
from repro_torch.optim.adamw import adamw_init

SKIP = {
    # long_500k needs sub-quadratic attention (DESIGN.md §4): only the SSM
    # and hybrid archs run it; pure full-attention archs skip by assignment.
    ("whisper-large-v3", "long_500k"): "full attention (O(S) KV decode at 512k infeasible)",
    ("qwen1.5-0.5b", "long_500k"): "full attention",
    ("phi3-medium-14b", "long_500k"): "full attention",
    ("minitron-4b", "long_500k"): "full attention",
    ("starcoder2-3b", "long_500k"): "full attention",
    ("pixtral-12b", "long_500k"): "full attention",
    ("llama4-scout-17b-a16e", "long_500k"): "full attention",
    ("qwen3-moe-235b-a22b", "long_500k"): "full attention",
}

BYTES_NOTE = ("sum of every aten op's input and output bytes, views excluded, a kernel's "
              "meta route its own inputs and outputs once: an upper bound, no fusion")


def card_bytes() -> tuple[int, str]:
    """(bytes, source) of the card a cell must fit."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"total_memory of {props.name}"
    return CARD_BYTES_DEFAULT, "80 GiB (no card present: the H100's data sheet)"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Accountant(TorchDispatchMode):
    """Counts the bytes every aten op reads and writes, and the live
    storage bytes of the tensors ops create (each storage counted once,
    released when its last tensor dies), with their peak.  Storages of
    ``base`` (the step's arguments) are not counted as live: they are the
    arguments' bytes.  Ops inside a kernel's meta route count no bytes
    (the route records the kernel's own) and set no peak."""

    def __init__(self, base=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._base = {_key(t) for t in base}
        self._refs: dict[int, int] = {}
        self._seen = WeakIdKeyDictionary()

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        if t in self._seen:
            return
        key = _key(t)
        if key in self._base:
            return
        self._seen[t] = True
        nbytes = t.untyped_storage().nbytes()
        if key in self._refs:
            self._refs[key] += 1
        else:
            self._refs[key] = 1
            self.live += nbytes
        weakref.finalize(t, self._release, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors(out))
        if not meta.inside():
            if not func.is_view:
                self.bytes += meta.nbytes(*_tensors(args), *_tensors(kwargs or {}), *outs)
        for t in outs:
            self._track(t)
        if not meta.inside():
            self.peak = max(self.peak, self.live)
        return out


def build_cell(model: Model, shape: ShapeConfig, *, expert_ranks: int = 0):
    """-> (step, arguments, group): ``step()`` runs the cell's step on meta
    tensors; ``arguments`` are the tensors it takes (parameters, optimizer
    state, batch, cache).  ``expert_ranks`` > 0 builds one rank of the
    expert-parallel route over ``group``, a stand-in that issues no
    collective and counts them (None otherwise)."""
    group = None
    if expert_ranks:
        from repro_torch.launch.mesh import dry_expert_mesh
        from repro_torch.models.transformer import init_expert_parallel

        group = dry_expert_mesh(1, expert_ranks)
        params = init_expert_parallel(model.cfg, group, device="meta")
    else:
        params = model.init(device="meta")
    args = list(params.parameters())
    if shape.kind == "train":
        opt = adamw_init(dict(params.named_parameters()))
        batch = model.batch_spec(shape)
        args += [opt.step, *_tensors(opt.m), *_tensors(opt.v), *batch.values()]
        return (lambda: train_step(model, params, opt, batch, peak_lr=3e-4,
                                   total_steps=10_000)), args, group
    if shape.kind == "prefill":
        batch = model.batch_spec(shape)
        args += list(batch.values())
        return (lambda: model.forward(params, batch)), args, group
    cache = model.init_decode_cache(shape.global_batch, shape.seq_len, device="meta")
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    args += [*_tensors(cache), tokens]
    return (lambda: model.decode_fn(params, cache, tokens)), args, group


def count_step(step, args) -> dict:
    """Run ``step()`` under the FLOP counter and the accountant."""
    meta.reset()
    acct = Accountant(args)
    with FlopCounterMode(display=False) as flop_counter:
        with acct:
            out = step()
        del out
    routes = meta.snapshot()
    aten_flops = float(flop_counter.get_total_flops())
    formula_flops = float(sum(r["flops"] for r in routes.values()))
    return {
        "flops": aten_flops + formula_flops,
        "flops_aten": aten_flops,
        "flops_formula": formula_flops,
        "bytes_accessed": float(acct.bytes + sum(r["bytes"] for r in routes.values())),
        "activation_peak_b": int(acct.peak),
        "meta_routes": routes,
    }


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def run_cell(arch, shape, *, expert_ranks: int = 0) -> dict:
    """One cell: ``arch`` an arch id (or a ``ModelConfig``), ``shape`` a name
    of ``SHAPES`` (or a ``ShapeConfig``)."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    shape = _shape(shape)
    if (cfg.name, shape.name) in SKIP:
        return {"arch": cfg.name, "shape": shape.name, "status": "SKIP",
                "reason": SKIP[(cfg.name, shape.name)]}
    if not cfg.is_moe:
        expert_ranks = 0  # JAX's rule override: nothing to shard without experts
    model = get_model(cfg)
    t0 = time.time()
    step, args, group = build_cell(model, shape, expert_ranks=expert_ranks)
    arg_bytes = meta.nbytes(*{_key(t): t for t in args}.values())
    counted = count_step(step, args)
    trace_s = time.time() - t0
    cap, cap_source = card_bytes()
    peak = arg_bytes + counted["activation_peak_b"]
    n_dev = expert_ranks or 1
    coll = collective_bytes({}, {}) if group is None else group.collective_report()
    rl = roofline(counted["flops"], counted["bytes_accessed"], coll["total"])
    mf = model_flops(cfg, shape)
    rl["model_flops_global"] = mf
    rl["model_flops_per_dev"] = mf / n_dev
    rl["counted_flops_per_dev"] = counted["flops"]
    rl["useful_flop_ratio"] = (mf / n_dev) / counted["flops"] if counted["flops"] else 0.0
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": f"1 rank of {expert_ranks} (expert parallel)" if expert_ranks else "1 (one H100)",
        "status": "OK",
        "remat": L.REMAT_POLICY[0],
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_size_b": int(arg_bytes),
            "activation_peak_b": counted["activation_peak_b"],
            "peak_estimate_b": int(peak),
            "card_bytes": cap,
            "card_bytes_source": cap_source,
            "fits": bool(peak <= cap),
        },
        "cost": {
            "flops": counted["flops"],
            "flops_aten": counted["flops_aten"],
            "flops_formula": counted["flops_formula"],
            "bytes_accessed": counted["bytes_accessed"],
            "bytes_note": BYTES_NOTE,
            "meta_routes": counted["meta_routes"],
        },
        "collectives": {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": coll["counts"],
        "roofline": rl,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                      "source": "NVIDIA H100 SXM data sheet; host counts, not card times"},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (assignment spelling)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default=None, help="write/merge JSON results here")
    ap.add_argument("--moe-impl", default=None, choices=["gspmd", "shard_map"],
                    help="MoE route: gspmd (the one-card route, default) or shard_map "
                         "(one rank of the expert-parallel route, with --expert-ranks)")
    ap.add_argument("--expert-ranks", type=int, default=4,
                    help="model ranks of --moe-impl shard_map (E must divide by it)")
    ap.add_argument("--remat", default=None, choices=list(L.REMAT_POLICIES),
                    help="remat policy of the training step")
    args = ap.parse_args(argv)
    if args.remat:
        L.REMAT_POLICY[0] = args.remat
    expert_ranks = args.expert_ranks if args.moe_impl == "shard_map" else 0

    cells = []
    if args.all:
        cells = [(arch, shape) for arch in ALIASES for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results if r.get("status") != "ERROR"}

    for arch, shape in cells:
        name = get_config(arch).name
        if (name, shape) in done:
            print(f"[skip-done] {name} × {shape}")
            continue
        print(f"[dryrun] {name} × {shape} on one H100 (meta) ...", flush=True)
        try:
            r = run_cell(arch, shape, expert_ranks=expert_ranks)
        except Exception:
            r = {"arch": name, "shape": shape, "status": "ERROR",
                 "traceback": traceback.format_exc(limit=10)}
        results = [x for x in results if not (x["arch"] == name and x["shape"] == shape)] + [r]
        if r["status"] == "OK":
            m, rl = r["memory"], r["roofline"]
            print(f"  OK trace={r['trace_s']}s args={m['argument_size_b'] / 2**30:.2f}GiB "
                  f"peak={m['peak_estimate_b'] / 2**30:.2f}GiB fits={m['fits']} "
                  f"flops={r['cost']['flops']:.4g} bytes={r['cost']['bytes_accessed']:.4g} "
                  f"coll={r['collectives']['total'] / 2**20:.1f}MiB dominant={rl['dominant']} "
                  f"useful={rl['useful_flop_ratio']:.3f}", flush=True)
        else:
            print(f"  {r['status']}: {r.get('reason', '')}{r.get('traceback', '')[-600:]}",
                  flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_err = sum(r["status"] == "ERROR" for r in results)
    print(f"dryrun complete: {n_ok} OK, {n_skip} SKIP, {n_err} ERROR")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
