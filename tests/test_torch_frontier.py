"""Frontier pools: the port's batched ops against the JAX ops vmapped over
workers, on random pools with many equal depths (ties) and empty workers.

Hazards named here:
* ``pop_deepest_cheap`` picks the lowest slot among the deepest, and slot 0
  with ``valid`` False for an empty worker;
* ``lax.top_k`` in ``pop_k_shallowest`` puts the lower slot first among
  equal depths; the port uses a stable argsort;
* ``push_many`` into a saturated pool drops exactly what does not fit
  (JAX's ``mode="drop"`` scatter; the port masks explicitly);
* ``push_many_`` writes the same pool into ``f``'s own tensors, with no
  host sync and no temporary of the pool's (P, CAP, W) size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_masks, t32, u32
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import frontier as jf
from repro_torch.core import frontier as tf

P, CAP, W = 5, 16, 2


def _pools(seed, fill=None, w=W):
    """JAX and port frontiers holding the same random pools of ``w`` words:
    depths from a small range (many ties), per-worker fill rates, worker 0
    empty."""
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 32 * w, w, P * CAP).reshape(P, CAP, w)
    sols = random_masks(rng, 32 * w, w, P * CAP).reshape(P, CAP, w)
    depths = rng.integers(0, 4, size=(P, CAP)).astype(np.int32)
    rate = rng.random((P, 1)) if fill is None else np.full((P, 1), fill)
    active = rng.random((P, CAP)) < rate
    active[0] = False
    overflow = np.zeros(P, bool)
    dropped = rng.integers(0, 3, size=P).astype(np.int32)
    jax_f = jf.Frontier(
        masks=jnp.asarray(masks), sols=jnp.asarray(sols),
        depths=jnp.asarray(depths), active=jnp.asarray(active),
        overflow=jnp.asarray(overflow), dropped=jnp.asarray(dropped),
    )
    torch_f = tf.Frontier(
        masks=t32(masks), sols=t32(sols), depths=torch.from_numpy(depths),
        active=torch.from_numpy(active), overflow=torch.from_numpy(overflow),
        dropped=torch.from_numpy(dropped),
    )
    return jax_f, torch_f


def _same(jax_x, torch_x, what):
    want = np.asarray(jax_x)
    got = u32(torch_x) if want.dtype == np.uint32 else torch_x.numpy()
    assert got.shape == want.shape, what
    assert (got == want).all(), what


def _same_frontier(jax_f, torch_f):
    for name in jf.Frontier._fields:
        _same(getattr(jax_f, name), getattr(torch_f, name), name)


def _same_pop(jax_out, torch_out):
    _same_frontier(jax_out[0], torch_out[0])
    for what, a, b in zip(("masks", "sols", "depths", "valid"), jax_out[1:], torch_out[1:]):
        _same(a, b, what)


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_pop_deepest_cheap(count, seed):
    jax_f, torch_f = _pools(seed)
    want = jax.vmap(lambda f: jf.pop_deepest_cheap(f, count))(jax_f)
    _same_pop(want, tf.pop_deepest_cheap(torch_f, count))


@pytest.mark.parametrize("count", [1, 3, 5])
@pytest.mark.parametrize("seed", range(4))
def test_pop_k_shallowest_with_limit(count, seed):
    jax_f, torch_f = _pools(100 + seed)
    limit = np.random.default_rng(seed).integers(0, count + 2, size=P).astype(np.int32)
    want = jax.vmap(lambda f, lim: jf.pop_k_shallowest(f, count, limit=lim))(
        jax_f, jnp.asarray(limit)
    )
    _same_pop(want, tf.pop_k_shallowest(torch_f, count, limit=torch.from_numpy(limit)))
    # without a limit: every candidate that was active is popped
    want = jax.vmap(lambda f: jf.pop_k_shallowest(f, count))(jax_f)
    _same_pop(want, tf.pop_k_shallowest(torch_f, count))


@pytest.mark.parametrize("K", [2, 7, 20])
@pytest.mark.parametrize("seed", range(4))
def test_push_many_into_saturated_pools(K, seed):
    jax_f, torch_f = _pools(200 + seed, fill=0.85)  # few free slots
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 64, W, P * K).reshape(P, K, W)
    sols = random_masks(rng, 64, W, P * K).reshape(P, K, W)
    depths = rng.integers(0, 9, size=(P, K)).astype(np.int32)
    valid = rng.random((P, K)) < 0.7
    want = jax.vmap(jf.push_many)(
        jax_f, jnp.asarray(masks), jnp.asarray(sols), jnp.asarray(depths),
        jnp.asarray(valid),
    )
    got = tf.push_many(
        torch_f, t32(masks), t32(sols), torch.from_numpy(depths),
        torch.from_numpy(valid),
    )
    _same_frontier(want, got)
    if K == 20:  # more valid tasks than free slots somewhere
        assert bool(got.overflow.any())
        assert (got.dropped.numpy() > np.asarray(jax_f.dropped)).any()


def _children(seed, lead, K, w):
    """Random (masks, sols, depths, valid) of K tasks a worker, numpy."""
    rng = np.random.default_rng(seed)
    T = int(np.prod(lead)) * K
    return (
        random_masks(rng, 32 * w, w, T).reshape(*lead, K, w),
        random_masks(rng, 32 * w, w, T).reshape(*lead, K, w),
        rng.integers(0, 9, size=(*lead, K)).astype(np.int32),
        rng.random((*lead, K)) < 0.7,
    )


def _torch_rows(children):
    masks, sols, depths, valid = children
    return t32(masks), t32(sols), torch.from_numpy(depths), torch.from_numpy(valid)


# K = 1 is the data plane's push (donate_k 1), K = 8 an explore round's
# (2 children of 4 lanes); fill 0.97 leaves most workers a slot or none
PUSH_CASES = [
    (w, K, fill) for w in (1, 19) for K in (1, 8) for fill in (None, 0.97)
]


@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
@pytest.mark.parametrize("w,K,fill", PUSH_CASES)
@pytest.mark.parametrize("seed", range(2))
def test_push_many_in_place_against_jax(w, K, fill, batched, seed):
    """``push_many_`` writes, into ``f``'s own tensors, the pool that
    ``push_many`` returns and that JAX's ``push_many`` (vmapped over workers,
    and over instances for the ``_b`` view) gives, leaf for leaf; the
    functional ``push_many`` leaves its input as it was."""
    if batched:
        jax_f, torch_f = _stacked_pools(500 + seed, 3, fill=fill, w=w)
        lead, jax_push = (3, P), jax.vmap(jf.push_many_b)
    else:
        jax_f, torch_f = _pools(500 + seed, fill=fill, w=w)
        lead, jax_push = (P,), jax.vmap(jf.push_many)
    children = _children(seed, lead, K, w)
    want = jax_push(jax_f, *map(jnp.asarray, children))

    before = [x.clone() for x in torch_f]
    push = tf.push_many_b if batched else tf.push_many
    _same_frontier(want, push(torch_f, *_torch_rows(children)))
    assert all(torch.equal(a, b) for a, b in zip(before, torch_f))

    ptrs = [x.data_ptr() for x in torch_f]
    flat = tf.Frontier(*(x.reshape(-1, *x.shape[len(lead):]) for x in torch_f))
    rows = [x.reshape(-1, *x.shape[len(lead):]) for x in _torch_rows(children)]
    out = tf.push_many_(flat, *rows)
    assert all(a is b for a, b in zip(out, flat))
    assert [x.data_ptr() for x in torch_f] == ptrs
    _same_frontier(want, torch_f)  # written through the flat views
    if fill is not None and K == 8:  # saturated: some pushes were dropped
        assert bool(torch_f.overflow.any())
        assert (torch_f.dropped.numpy() > before[5].numpy()).any()


SYNC_OPS = {"nonzero", "_local_scalar_dense", "item", "is_nonzero", "equal",
            "masked_select", "unique", "_unique2"}


class _Ops(TorchDispatchMode):
    """Records each op's name and the tensors it returns."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((func.overloadpacket.__name__,
                         [x for x in outs if isinstance(x, torch.Tensor)]))
        return out


@pytest.mark.parametrize("K", [1, 8])
def test_push_many_in_place_has_no_pool_sized_temporary_or_host_sync(K):
    """No op of ``push_many_`` makes a tensor of the pool's P·CAP·W elements
    (the in-place writes return the pool itself) and none reads a value back
    to the host."""
    w = 3
    _, f = _pools(600 + K, w=w)
    rows = _torch_rows(_children(K, (P,), K, w))
    pools = {f.masks.data_ptr(), f.sols.data_ptr()}
    rec = _Ops()
    with rec:
        tf.push_many_(f, *rows)
    names = [name for name, _ in rec.ops]
    assert "scatter_add_" in names
    assert not SYNC_OPS & set(names), names
    big = [(name, tuple(x.shape)) for name, outs in rec.ops for x in outs
           if x.numel() >= P * CAP * w and x.data_ptr() not in pools]
    assert not big, big


# -- the helpers of the reference explore path and the batched views ----------
# (``tests/test_frontier.py``'s cases, each held against the JAX op vmapped
# over workers -- or over instances and workers -- as one port call)


def _push_both(jax_f, torch_f, depth_rows):
    """Push the same rows into both packages' P-worker pools: row w of
    ``depth_rows`` goes to worker w, task i's mask words are i + 1."""
    K = max(len(r) for r in depth_rows)
    Pn = len(depth_rows)
    depths = np.zeros((Pn, K), np.int32)
    valid = np.zeros((Pn, K), bool)
    for w, row in enumerate(depth_rows):
        depths[w, : len(row)] = row
        valid[w, : len(row)] = True
    masks = np.tile(np.arange(1, K + 1, dtype=np.uint32)[None, :, None], (Pn, 1, W))
    sols = masks[..., ::-1] * np.uint32(7)
    jax_f = jax.vmap(jf.push_many)(jax_f, jnp.asarray(masks), jnp.asarray(sols),
                                   jnp.asarray(depths), jnp.asarray(valid))
    torch_f = tf.push_many(torch_f, t32(masks), t32(sols), torch.from_numpy(depths),
                           torch.from_numpy(valid))
    return jax_f, torch_f


def _empty_both(Pn, cap):
    jax_f = jax.vmap(lambda _: jf.make_frontier(cap, W))(jnp.arange(Pn))
    return jax_f, tf.make_frontier(Pn, cap, W, "cpu")


def test_make_frontier_equals_jax():
    jax_f, torch_f = _empty_both(3, 8)
    _same_frontier(jax_f, torch_f)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_push_then_pop_deepest_with_ties(count):
    """Equal depths: the lower slot comes first (``top_k``'s order); a worker
    with fewer tasks than ``count`` gets its lowest free slots, invalid."""
    jax_f, torch_f = _push_both(*_empty_both(4, 8), [[3, 1, 5], [2, 2, 2, 2], [], [7]])
    want = jax.vmap(lambda f: jf.pop_deepest(f, count))(jax_f)
    got = tf.pop_deepest(torch_f, count)
    _same_pop(want, got)
    assert got[4][0].all() and not got[4][2].any()


@pytest.mark.parametrize("seed", range(4))
def test_pop_deepest_on_random_pools(seed):
    jax_f, torch_f = _pools(300 + seed)
    for count in (1, 3, CAP):
        want = jax.vmap(lambda f: jf.pop_deepest(f, count))(jax_f)
        _same_pop(want, tf.pop_deepest(torch_f, count))


@pytest.mark.parametrize("seed", range(4))
def test_pop_shallowest_first_of_equal_minima(seed):
    jax_f, torch_f = _pools(400 + seed)  # depths 0-3: many equal minima
    want = jax.vmap(jf.pop_shallowest)(jax_f)
    got = tf.pop_shallowest(torch_f)
    _same_pop(want, got)
    assert not got[4][0]  # worker 0 is empty


def test_empty_pops_are_invalid():
    jax_f, torch_f = _empty_both(2, 4)
    _same_pop(jax.vmap(jf.pop_shallowest)(jax_f), tf.pop_shallowest(torch_f))
    want = jax.vmap(lambda f: jf.pop_deepest(f, 2))(jax_f)
    got = tf.pop_deepest(torch_f, 2)
    _same_pop(want, got)
    assert not got[4].any()


def test_push_one_overflow_and_exact_capacity():
    """``test_overflow_counts_every_dropped_push`` and
    ``test_push_pop_at_exact_capacity`` with ``push_one`` and ``push_many``:
    a full pool drops (and counts) each push, a pop frees a slot that the
    next push takes."""
    jax_f, torch_f = _empty_both(2, 2)
    jax_f, torch_f = _push_both(jax_f, torch_f, [[4, 9], [1]])
    for depth in (7, 8):
        mask = np.full((2, W), depth, np.uint32)
        d = np.full((2,), depth, np.int32)
        v = np.ones((2,), bool)
        jax_f = jax.vmap(jf.push_one)(jax_f, jnp.asarray(mask), jnp.asarray(mask),
                                      jnp.asarray(d), jnp.asarray(v))
        torch_f = tf.push_one(torch_f, t32(mask), t32(mask), torch.from_numpy(d),
                              torch.from_numpy(v))
        _same_frontier(jax_f, torch_f)
    assert torch_f.dropped.tolist() == [2, 1] and torch_f.overflow.all()
    want = jax.vmap(lambda f: jf.pop_deepest(f, 1))(jax_f)
    got = tf.pop_deepest(torch_f, 1)
    _same_pop(want, got)
    jax_f, torch_f = _push_both(want[0], got[0], [[5], [6]])
    _same_frontier(jax_f, torch_f)
    assert torch_f.dropped.tolist() == [2, 1]
    assert tf.pending_per_worker(torch_f).tolist() == [2, 2]


@pytest.mark.parametrize("seed", range(6))
def test_multiset_conservation_against_jax(seed):
    """``test_multiset_conservation``: a random op sequence (pushes, deepest
    pops of 1-3 lanes, shallowest pops) on P workers at once; after every op
    both packages hold the same pools and pop the same tasks, and the
    pending counts follow a multiset model per worker."""
    rng = np.random.default_rng(seed)
    Pn, cap = 3, 32
    jax_f, torch_f = _empty_both(Pn, cap)
    model = [[] for _ in range(Pn)]
    for _ in range(40):
        op = rng.integers(0, 3)
        if op == 0:
            rows = [list(rng.integers(0, 100, size=rng.integers(1, 5))) for _ in range(Pn)]
            jax_f, torch_f = _push_both(jax_f, torch_f, rows)
            for w in range(Pn):
                model[w].extend(rows[w][: max(0, cap - len(model[w]))])
        elif op == 1:
            count = int(rng.integers(1, 4))
            want = jax.vmap(lambda f: jf.pop_deepest(f, count))(jax_f)
            got = tf.pop_deepest(torch_f, count)
            _same_pop(want, got)
            for w in range(Pn):
                popped = sorted(got[3][w][got[4][w]].tolist())
                assert popped == sorted(sorted(model[w], reverse=True)[: len(popped)])
                for d in popped:
                    model[w].remove(d)
            jax_f, torch_f = want[0], got[0]
        else:
            want = jax.vmap(jf.pop_shallowest)(jax_f)
            got = tf.pop_shallowest(torch_f)
            _same_pop(want, got)
            for w in range(Pn):
                assert bool(got[4][w]) == bool(model[w])
                if model[w]:
                    assert int(got[3][w]) == min(model[w])
                    model[w].remove(int(got[3][w]))
            jax_f, torch_f = want[0], got[0]
        assert tf.pending_per_worker(torch_f).tolist() == [len(m) for m in model]


def _stacked_pools(seed, Bn=3, fill=None, w=W):
    """(B, P, CAP) pools of both packages: B independent random pools."""
    pairs = [_pools(seed * 10 + b, fill=fill, w=w) for b in range(Bn)]
    jax_f = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    torch_f = tf.Frontier(*(torch.stack(xs) for xs in zip(*[p[1] for p in pairs])))
    return jax_f, torch_f


@pytest.mark.parametrize("seed", range(3))
def test_batched_views_are_per_instance(seed):
    """The ``_b`` views on (B, P, ...) pools equal the JAX per-instance views
    vmapped once more over instances, and ``pending_per_instance`` sums each
    instance's workers."""
    Bn, K = 3, 4
    jax_f, torch_f = _stacked_pools(seed, Bn)
    assert tf.pending_per_instance(torch_f).tolist() == np.asarray(
        jf.pending_per_instance(jax_f)).tolist()
    want = jax.vmap(lambda f: jf.pop_deepest_b(f, 2))(jax_f)
    _same_pop(want, tf.pop_deepest_b(torch_f, 2))
    limit = np.random.default_rng(seed).integers(0, 4, size=(Bn, P)).astype(np.int32)
    want = jax.vmap(lambda f, lim: jf.pop_k_shallowest_b(f, 3, lim))(jax_f, jnp.asarray(limit))
    _same_pop(want, tf.pop_k_shallowest_b(torch_f, 3, torch.from_numpy(limit)))
    rng = np.random.default_rng(seed)
    masks = random_masks(rng, 64, W, Bn * P * K).reshape(Bn, P, K, W)
    depths = rng.integers(0, 9, size=(Bn, P, K)).astype(np.int32)
    valid = rng.random((Bn, P, K)) < 0.7
    want = jax.vmap(jf.push_many_b)(jax_f, jnp.asarray(masks), jnp.asarray(masks),
                                    jnp.asarray(depths), jnp.asarray(valid))
    got = tf.push_many_b(torch_f, t32(masks), t32(masks), torch.from_numpy(depths),
                         torch.from_numpy(valid))
    _same_frontier(want, got)
    # the instance axis is independent: instance 1 alone gives the same pool
    alone = tf.push_many(tf.Frontier(*(x[1] for x in torch_f)), t32(masks[1]),
                         t32(masks[1]), torch.from_numpy(depths[1]),
                         torch.from_numpy(valid[1]))
    for a, b in zip(alone, got):
        assert torch.equal(a, b[1])
