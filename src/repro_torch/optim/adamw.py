"""AdamW with a cosine schedule and global-norm clipping.

The port of ``repro/optim/adamw.py``, as plain functions on trees of
tensors: nested dicts (keys in sorted order, as JAX flattens them), lists
and tuples, or a flat dict of a module's named parameters.  The moments are
f32 whatever the parameter's dtype, and every rounding point of the JAX
update is kept:

* ``g32 = g.float() * scale`` with ``scale = min(1, clip / max(gnorm, 1e-9))``;
* ``update = (m / bc1) / (sqrt(v / bc2) + eps)``, then ``update + wd·p``,
  then ``p − lr·update`` in f32, then a cast back to the parameter's dtype
  (so a bf16 parameter is rounded to bf16 every step);
* the bias corrections ``1 − b ** step`` with ``step`` in f32.

Not ``torch.optim.AdamW``: it decays as ``p·(1 − lr·wd)`` and its clipping
helper adds 1e-6 to the norm, so it drifts from the JAX update in the last
bits.  ``opt_state_specs`` is left out: it only gives the sharding of the
state over a JAX mesh.  The step, the learning rate and the norm stay on
the parameters' device, so an update waits for no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's order
    (dict keys sorted); None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples of
    tensors) and the matching leaves of ``rest``, the structure kept; a node
    for which ``is_leaf`` is true is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    sub = lambda t, *r: tree_map(fn, t, *r, is_leaf=is_leaf)  # noqa: E731
    if isinstance(tree, dict):
        return {k: sub(tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def adamw_init(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(step=step,
                    m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree, reduce_sumsq=None) -> torch.Tensor:
    """sqrt of the sum of the leaves' f32 sums of squares, added in the
    tree's leaf order.

    ``reduce_sumsq`` makes it the norm of a tree that ranks hold in shards:
    it maps the (n_leaves,) vector of this rank's sums of squares, in leaf
    order, to the whole tree's (``launch/train.py`` sums the expert shards'
    entries over the model ranks), before the same adds."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if reduce_sumsq is not None:
        sums = reduce_sumsq(torch.stack(sums)).unbind()
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps, final_frac=0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``final_frac·peak_lr`` at ``total_steps``; ``step`` an int tensor."""
    step = step.float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def adamw_update(
    params,
    grads,
    opt: OptState,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    reduce_sumsq=None,
):
    """One AdamW step with global-norm clipping -> (params, opt, stats):
    each leaf's new parameter, ``m`` and ``v`` are written over the old ones
    in ``params``, ``opt.m`` and ``opt.v`` (which are returned, with the new
    step), leaf by leaf, so one leaf's new state is alive at a time and not
    a second copy of the whole state; ``stats`` holds the pre-clip
    ``grad_norm`` (``reduce_sumsq`` as :func:`global_norm`'s) and the step's
    ``lr``."""
    gnorm = global_norm(grads, reduce_sumsq)
    scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = opt.step + 1
    lr = cosine_schedule(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                         total_steps=total_steps)
    step32 = step.float()
    f32 = dict(dtype=torch.float32, device=step.device)
    bc1 = 1 - torch.pow(torch.tensor(b1, **f32), step32)
    bc2 = 1 - torch.pow(torch.tensor(b2, **f32), step32)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        update = update + weight_decay * p.float()
        p_new = p.float() - lr * update
        for dst, src in zip((p, m, v), (p_new, m_new, v_new)):
            dst.copy_(src)  # the cast back to p's dtype rounds as .to() does

    tree_map(upd, params, grads, opt.m, opt.v)
    return params, OptState(step=step, m=opt.m, v=opt.v), {"grad_norm": gnorm, "lr": lr}
