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

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt
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
from repro_torch.models.convert import export_params, export_tree, import_tree, load_jax_params
from repro_torch.models.registry import Model, get_model
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step(model: Model, params: torch.nn.Module, opt: OptState, batch: dict, *,
               peak_lr: float, total_steps: int, times: dict | None = None):
    """One step of JAX's ``step_fn``: the loss and its gradient, then AdamW;
    ``params`` is updated in place.  A parameter the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it (AdamW still decays it).
    -> (opt, loss, grad_norm), the last two scalar tensors on the device.  With
    ``times`` the device is synchronised between the three parts and their
    walls added under ``forward_ms``, ``backward_ms`` and ``optimizer_ms``."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    marks = [time.perf_counter()]

    def mark():
        if times is not None:
            _sync(dev)
            marks.append(time.perf_counter())

    loss = model.loss_fn(params, batch)
    mark()
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    mark()
    with torch.no_grad():
        new, opt, stats = adamw_update({k: p.detach() for k, p in named.items()}, grads, opt,
                                       peak_lr=peak_lr, total_steps=total_steps)
        for k, p in named.items():
            p.copy_(new[k])
    mark()
    if times is not None:
        for name, t0, t1 in zip(("forward_ms", "backward_ms", "optimizer_ms"), marks, marks[1:]):
            times[name] = times.get(name, 0.0) + (t1 - t0) * 1e3
    return opt, loss.detach(), stats["grad_norm"]


def state_tree(params: torch.nn.Module, opt: OptState):
    """The training state as JAX's ``train_loop`` checkpoints it:
    ``(params, OptState)`` in the JAX layout."""
    return (export_params(params),
            OptState(step=opt.step, m=export_tree(params, opt.m), v=export_tree(params, opt.v)))


def load_state(params: torch.nn.Module, tree) -> OptState:
    """``tree`` (as ``state_tree`` makes it) into ``params``; -> the
    optimizer state over the port's parameter names."""
    ptree, opt = tree
    load_jax_params(params, ptree)
    return OptState(step=opt.step, m=import_tree(opt.m), v=import_tree(opt.v))


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
):
    """-> (params, opt, losses): the trained module, the optimizer state
    over its parameter names and the float loss of each step run.  ``times``
    (optional) gathers ``train_step``'s part walls."""
    dev = resolve_device(device)
    model = get_model(cfg)
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=seq + 1, global_batch=batch, seed=seed)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
    start = 0

    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, start, extra = restore_checkpoint(ckpt_dir, state_tree(params, opt), device=dev)
        opt = load_state(params, tree)
        pipe.restore(extra["data"])
        print(f"[train] resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for it in range(start, steps):
        b = pipe.next_batch(device=dev)
        b.update(step_inputs(cfg, batch, seed, it, dev))
        opt, loss, gnorm = train_step(model, params, opt, b, peak_lr=peak_lr,
                                      total_steps=max(steps, 1), times=times)
        losses.append(float(loss))
        if it % log_every == 0 or it == steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {it:5d} loss {float(loss):7.4f} "
                  f"gnorm {float(gnorm):6.2f} ({dt:.1f}s)", flush=True)
        if ckpt_dir and (it + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, it + 1, state_tree(params, opt),
                            extra={"data": pipe.state()}, blocking=False)
    if ckpt_dir:
        wait_for_pending()
        save_checkpoint(ckpt_dir, steps, state_tree(params, opt), extra={"data": pipe.state()})
    return params, opt, losses


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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, _, losses = train_loop(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        peak_lr=args.lr,
        seed=args.seed,
        device=args.device,
    )
    k = max(len(losses) // 10, 1)
    print(f"[train] first-{k} mean loss {sum(losses[:k])/k:.4f} -> "
          f"last-{k} mean loss {sum(losses[-k:])/k:.4f}")
    return losses


if __name__ == "__main__":
    main()
