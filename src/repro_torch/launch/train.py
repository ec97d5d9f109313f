"""Training entry point of the port: real steps on the card, fault-tolerant.

The port of ``repro/launch/train.py``: the same ``train_loop`` and the same
flags, plus ``--device``.  A step (``train_step``) takes the model's
``loss_fn`` and its gradient with torch autograd, each block rematerialised
as JAX's ``jax.checkpoint`` does, then the port's ``adamw_update`` (JAX's
rounding points).  The forward runs both LM kernels on the card
(``flash_attention``, ``wkv6``), each launched again in the recompute; their
backward is the gradient of their plain versions, which is the gradient JAX
takes through ``attn_impl="blockwise"`` and ``wkv_impl="ref"``.

Fault tolerance, as in JAX:

* a checkpoint every ``--ckpt-every`` steps (an asynchronous write: the
  state is copied to the host at once and written by a thread, with an
  atomic rename), holding ``(params, OptState)`` in the JAX layout
  (``models/convert.export_tree``) and the data cursor, so a file written by
  either package resumes in the other;
* ``--resume`` restores the latest checkpoint; the deterministic pipeline
  regenerates the same batches, so the loss curve continues exactly.

A bf16 state is stored as JAX stores bf16 (``|V2``) and resumes in the port;
the JAX package's ``restore_checkpoint`` cannot cast ``|V2`` back, so it
resumes only an f32 state (ROADMAP section 3).  The port's seeded init
(a torch generator) cannot equal ``jax.random``'s.

Expert parallelism (JAX's ``--moe-impl shard_map`` step, ``launch/dryrun.py``'s
``value_and_grad`` through ``_moe_shard_map``): ``--data-ranks D
--expert-ranks M`` train an MoE config on D·M ranks of this host
(``spawn_mesh``; gloo where ranks share a card, NCCL with a card a rank), an
``ExpertMesh`` grid whose rank (d, m) holds experts [m·E/M, (m+1)·E/M) of
every layer and rows [d·B/D, (d+1)·B/D) of each global batch (B % D != 0
raises ``ValueError``).  A step (``train_step`` on a model with an attached
mesh): each rank's loss is the mean over its own rows, the MoE collectives
carry JAX's transposes under autograd (``models/moe.py``), every gradient is
averaged over the rank's data column, the global norm sums the expert
shards' squares over the model ranks and counts each replicated leaf once,
and AdamW updates each rank's shard in place.  A checkpoint holds the whole
banks in JAX's layout (the model ranks' shards gathered, written by rank
(0, 0)); a restore cuts them to the rank's experts, so a grid's checkpoint
resumes in one process and the reverse.  Rank 0 prints the ``[train]``
lines.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b --smoke \\
      --device cpu --data-ranks 2 --expert-ranks 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.session import resolve_device
from repro_torch.checkpoint.store import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending,
)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.convert import (
    expert_shard,
    export_params,
    export_tree,
    import_tree,
    load_jax_params,
)
from repro_torch.models.moe import MoE
from repro_torch.models.registry import Model, get_model
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update

# the kernel libraries a training rank launches, built once before the ranks start
TRAIN_LIBRARIES = ("flash_attention", "flash_attention_wgmma")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def expert_mesh(params: torch.nn.Module):
    """The ``ExpertMesh`` attached to ``params``' MoE layers, or None."""
    return next((m.ep for m in params.modules() if isinstance(m, MoE) and m.ep is not None),
                None)


def expert_leaves(params: torch.nn.Module) -> set:
    """The names of ``params``' expert banks (``w1``/``w3``/``w2``): the
    leaves an expert-parallel rank holds a shard of."""
    return {f"{name}.{w}" for name, m in params.named_modules() if isinstance(m, MoE)
            for w in ("w1", "w3", "w2")}


def _data_mean(ep, grads: dict) -> None:
    """Each gradient averaged over the rank's data column, in place: one
    all-reduce of the leaves flattened to f32, divided by D, cast back."""
    keys = sorted(grads)
    flat = ep.data.all_sum(torch.cat([grads[k].float().flatten() for k in keys])) / ep.data.size
    for k, part in zip(keys, flat.split([grads[k].numel() for k in keys])):
        grads[k].copy_(part.view_as(grads[k]))


def _sharded_sumsq(ep, sharded: list):
    """``global_norm``'s ``reduce_sumsq`` on rank ``ep``: the expert shards'
    sums of squares (``sharded``, a bool a leaf in leaf order) summed over
    the model ranks, the replicated leaves' kept (counted once)."""
    if ep.model.size == 1:
        return None

    def reduce(sums):
        mask = torch.tensor(sharded, device=sums.device)
        return torch.where(mask, ep.model.all_sum(torch.where(mask, sums, 0.0)), sums)

    return reduce


def value_and_grad(model: Model, params: torch.nn.Module, batch: dict, mark=None):
    """The loss and its gradient: -> (loss, {parameter name: gradient}), as
    ``jax.value_and_grad(model.loss_fn)``.  A parameter the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it.  ``mark`` (a
    callable) is called between the forward and the backward.

    With an ``ExpertMesh`` attached to ``params`` (``init_expert_parallel``),
    the rank's share of the grid's: ``batch`` is its rows, its loss their
    mean; the gradients (of its expert shards, and the whole replicated
    leaves) are averaged over its data column, none to average on one data
    rank, and the loss returned is the mean over the data ranks, the global
    batch's.  Every rank of a column returns the same numbers, every model
    rank the same replicated gradients."""
    named = dict(params.named_parameters())
    loss = model.loss_fn(params, batch)
    if mark is not None:
        mark()
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    loss = loss.detach()
    ep = expert_mesh(params)
    if ep is not None and ep.data.size > 1:
        _data_mean(ep, grads)
        loss = ep.data.all_mean(loss)
    return loss, grads


def train_step(model: Model, params: torch.nn.Module, opt: OptState, batch: dict, *,
               peak_lr: float, total_steps: int, times: dict | None = None):
    """One step of JAX's ``step_fn``: :func:`value_and_grad`, then AdamW,
    which writes each leaf's new parameter, ``m`` and ``v`` over the old
    ones (``params`` and ``opt``'s moments are updated in place: one leaf's
    new state alive at a time).  -> (opt, loss, grad_norm), the last two
    scalar tensors on the device.  With ``times`` the device is synchronised
    between the three parts and their walls added under ``forward_ms``,
    ``backward_ms`` and ``optimizer_ms``.

    On an expert-parallel rank the norm is the whole tree's (each expert
    shard's squares summed over the model ranks, each replicated leaf once),
    so the clip is the same on every rank, and AdamW updates the rank's
    leaves: every rank returns the same loss and norm."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    ep = expert_mesh(params)
    marks = [time.perf_counter()]

    def mark():
        if times is not None:
            _sync(dev)
            marks.append(time.perf_counter())

    loss, grads = value_and_grad(model, params, batch, mark)
    mark()
    with torch.no_grad():
        detached = {k: p.detach() for k, p in named.items()}
        reduce = None
        if ep is not None:
            shards = expert_leaves(params)
            sharded = [k in shards for k in sorted(grads)]  # global_norm's leaf order
            reduce = _sharded_sumsq(ep, sharded)
        _, opt, stats = adamw_update(detached, grads, opt, peak_lr=peak_lr,
                                     total_steps=total_steps, reduce_sumsq=reduce)
    mark()
    if times is not None:
        for name, t0, t1 in zip(("forward_ms", "backward_ms", "optimizer_ms"), marks, marks[1:]):
            times[name] = times.get(name, 0.0) + (t1 - t0) * 1e3
    return opt, loss, stats["grad_norm"]


def state_tree(params: torch.nn.Module, opt: OptState):
    """The training state as JAX's ``train_loop`` checkpoints it:
    ``(params, OptState)`` in the JAX layout."""
    return (export_params(params),
            OptState(step=opt.step, m=export_tree(params, opt.m), v=export_tree(params, opt.v)))


def load_state(params: torch.nn.Module, tree) -> OptState:
    """``tree`` (as ``state_tree`` makes it) into ``params``; -> the
    optimizer state over the port's parameter names.  On an expert-parallel
    rank the whole banks are cut to its experts (``expert_shard``)."""
    ptree, opt = tree
    m, v = opt.m, opt.v
    ep = expert_mesh(params)
    if ep is not None:
        ptree, m, v = (expert_shard(t, ep.model.rank, ep.model.size) for t in (ptree, m, v))
    load_jax_params(params, ptree)
    return OptState(step=opt.step, m=import_tree(m), v=import_tree(v))


def _whole_banks(tree: dict, ep) -> dict:
    """A transformer's JAX tree with each expert bank (L, E/M, ...) gathered
    over the model ranks into (L, E, ...): every rank of the row calls it."""
    moe = tree["blocks"]["moe"]
    whole = {k: ep.model.all_gather(moe[k].transpose(0, 1).contiguous()).transpose(0, 1)
             for k in ("w1", "w3", "w2")}
    return {**tree, "blocks": {**tree["blocks"], "moe": {**moe, **whole}}}


def checkpoint_tree(params: torch.nn.Module, opt: OptState):
    """The state to write, in JAX's layout: ``state_tree``, with an
    expert-parallel rank's banks, ``m`` and ``v`` gathered whole over its
    row.  None where the rank writes nothing: every rank but (0, 0), whose
    row alone gathers."""
    ep = expert_mesh(params)
    if ep is None:
        return state_tree(params, opt)
    if ep.data.rank:
        return None
    ptree, o = state_tree(params, opt)
    tree = (_whole_banks(ptree, ep),
            OptState(step=o.step, m=_whole_banks(o.m, ep), v=_whole_banks(o.v, ep)))
    return tree if ep.model.rank == 0 else None


def step_inputs(cfg, batch: int, seed: int, it: int, device) -> dict:
    """Step ``it``'s stub inputs beside the tokens, as JAX's loop draws them:
    an encdec's frames from ``seed·100_003 + it``, a VLM's patch embeddings
    from ``seed·100_019 + it``, standard normal in f32."""
    extra = {}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed * 100_003 + it)
        a = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model), np.float32)
        extra["frames"] = torch.from_numpy(a).to(device)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed * 100_019 + it)
        a = rng.standard_normal((batch, cfg.n_patches, cfg.d_model), np.float32)
        extra["patch_embeds"] = torch.from_numpy(a).to(device)
    return extra


def train_loop(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    peak_lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    device=None,
    times: dict | None = None,
    ep=None,
    gnorms: list | None = None,
):
    """-> (params, opt, losses): the trained module, the optimizer state
    over its parameter names and the float loss of each step run.  ``times``
    (optional) gathers ``train_step``'s part walls, ``gnorms`` each step's
    grad norm.  ``ep``: this rank's ``ExpertMesh`` (``launch.mesh``); the
    rank trains its experts on its data row's rows of each batch, and only
    rank 0 prints."""
    dev = resolve_device(device) if ep is None else ep.model.device
    model = get_model(cfg)
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=seq + 1, global_batch=batch, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if ep is None:
        params, rows, say = model.init(gen, dev), slice(None), print
    else:
        from repro_torch.models.transformer import init_expert_parallel

        D, d = ep.data.size, ep.data.rank
        if batch % D:
            raise ValueError(f"{D} data ranks do not divide a batch of {batch}: each data rank "
                             f"must hold as many tokens for the mean of their losses to be "
                             f"the global batch's")
        params, rows = init_expert_parallel(cfg, ep, gen, dev), slice(d * batch // D,
                                                                      (d + 1) * batch // D)
        first = d == 0 and ep.model.rank == 0
        say = print if first else (lambda *a, **k: None)
    opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
    start = 0

    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, start, extra = restore_checkpoint(ckpt_dir, state_tree(params, opt), device=dev)
        opt = load_state(params, tree)
        pipe.restore(extra["data"])
        say(f"[train] resumed from step {start}")

    def save(step, blocking):
        tree = checkpoint_tree(params, opt)
        if tree is not None:
            save_checkpoint(ckpt_dir, step, tree, extra={"data": pipe.state()},
                            blocking=blocking)

    losses = []
    t0 = time.perf_counter()
    for it in range(start, steps):
        b = pipe.next_batch(device=dev)
        b.update(step_inputs(cfg, batch, seed, it, dev))
        b = {k: v[rows] for k, v in b.items()}
        opt, loss, gnorm = train_step(model, params, opt, b, peak_lr=peak_lr,
                                      total_steps=max(steps, 1), times=times)
        losses.append(float(loss))
        if gnorms is not None:
            gnorms.append(float(gnorm))
        if it % log_every == 0 or it == steps - 1:
            dt = time.perf_counter() - t0
            say(f"[train] step {it:5d} loss {float(loss):7.4f} "
                f"gnorm {float(gnorm):6.2f} ({dt:.1f}s)", flush=True)
        if ckpt_dir and (it + 1) % ckpt_every == 0:
            save(it + 1, blocking=False)
    if ckpt_dir:
        wait_for_pending()
        save(steps, blocking=True)
    return params, opt, losses


def train_rank(mesh, spec: dict) -> dict:
    """One rank of ``main``'s expert-parallel run, started by ``spawn_mesh``
    on D·M ranks: its place in the (``data_ranks``, ``expert_ranks``) grid
    and ``train_loop`` over it (``spec`` holds the config and
    ``train_loop``'s keywords).  -> host values: the losses and grad norms,
    and the rank's (data, model) place."""
    from repro_torch.launch.mesh import make_expert_mesh

    ep = make_expert_mesh(spec["data_ranks"], spec["expert_ranks"], device=mesh.device)
    gnorms = []
    _, _, losses = train_loop(spec["cfg"], **spec["loop"], ep=ep, gnorms=gnorms)
    return {"data_rank": ep.data.rank, "model_rank": ep.model.rank,
            "backend": ep.model.backend, "losses": losses, "gnorms": gnorms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; there is no silent fallback to the CPU)")
    ap.add_argument("--expert-ranks", type=int, default=0,
                    help="train an MoE config expert-parallel over M ranks of this host (each "
                         "holds E/M experts; gloo where ranks share a card, NCCL with a card "
                         "a rank); 0: one process")
    ap.add_argument("--data-ranks", type=int, default=1,
                    help="with --expert-ranks: D data ranks, each training on its rows of "
                         "the batch (D x M ranks in all)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = dict(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume, peak_lr=args.lr,
                seed=args.seed)
    if args.expert_ranks:
        from repro_torch.launch.mesh import spawn_mesh

        D, M = args.data_ranks, args.expert_ranks
        if args.batch % D:
            raise ValueError(f"{D} data ranks do not divide a batch of {args.batch}")
        spec = dict(cfg=cfg, data_ranks=D, expert_ranks=M, loop=loop)
        ranks = spawn_mesh(train_rank, D * M, device=args.device, args=(spec,),
                           libraries=TRAIN_LIBRARIES)
        losses = ranks[0]["losses"]
    else:
        _, _, losses = train_loop(cfg, **loop, device=args.device)
    k = max(len(losses) // 10, 1)
    print(f"[train] first-{k} mean loss {sum(losses[:k])/k:.4f} -> "
          f"last-{k} mean loss {sum(losses[-k:])/k:.4f}")
    return losses


if __name__ == "__main__":
    main()
