"""The plane cache: repeat solves reuse their parametric plane functions.

The port of ``repro/api/cache.py``.  The plane builders
(:func:`repro_torch.core.superstep.build_plane_fn` /
``build_batch_plane_fn``) take the instance tensors as call-time arguments,
so one plane function serves every instance of one configuration.
:class:`PlaneCache` holds them keyed by ``(kind, problem, knobs, pad_words,
use_fpt)`` and keeps the JAX package's shape accounting: a *miss* is the
first call of a plane with a shape signature ``(n, W, capacity, P[, B])``,
a *hit* every later call with it.

PyTorch runs eagerly, so nothing is traced or compiled per shape here: a
hit saves building the plane function, not a compile.  So the JAX
package's ``plane_traces`` (its jax trace count) and ``bypasses`` (its mesh
solves, which skip the cache) have no counterpart.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import superstep


@dataclasses.dataclass
class CacheStats:
    """Warm/cold accounting for one :class:`PlaneCache`.

    ``misses``/``hits`` count shape-level first/repeat calls; ``planes`` is
    the number of plane functions this cache built; ``shapes`` the distinct
    shape signatures seen.
    """

    hits: int = 0
    misses: int = 0
    planes: int = 0
    shapes: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlaneCache:
    """Parametric planes, keyed by configuration; shared freely.

    A session owns one by default, but a cache may be passed to many
    sessions, so equal-config callers pool their planes.
    """

    def __init__(self):
        self._planes: dict = {}
        self._shapes: set = set()
        self.hits = 0
        self.misses = 0

    # -- plane lookup ----------------------------------------------------------

    @staticmethod
    def _plane_key(kind: str, spec, cfg, pad: int, use_fpt: bool) -> tuple:
        # key on the knobs the plane depends on, so configs differing only in
        # host-side knobs (max_rounds, compact_threshold, ...) share planes
        knobs = (
            cfg.steps_per_round, cfg.lanes, cfg.policy, cfg.packed_status,
            cfg.skip_empty_transfer, cfg.transfer_impl, cfg.explore_impl,
            cfg.donate_k, cfg.chunk_rounds,
        )
        return (kind, spec, knobs, pad, use_fpt)

    def _get(self, kind: str, spec, cfg, pad: int, use_fpt: bool):
        key = self._plane_key(kind, spec, cfg, pad, use_fpt)
        plane = self._planes.get(key)
        if plane is None:
            build = (
                superstep.build_plane_fn
                if kind == "solo"
                else superstep.build_batch_plane_fn
            )
            plane = build(
                spec,
                steps_per_round=cfg.steps_per_round,
                lanes=cfg.lanes,
                policy_priority=cfg.policy_priority,
                transfer_pad_words=pad,
                packed_status=cfg.packed_status,
                skip_empty_transfer=cfg.skip_empty_transfer,
                transfer_impl=cfg.transfer_impl,
                explore_impl=cfg.explore_impl,
                donate_k=cfg.donate_k,
                chunk_rounds=cfg.chunk_rounds,
                use_fpt=use_fpt,
            )
            self._planes[key] = plane
        return plane

    def solo_plane(self, spec, cfg, pad: int, use_fpt: bool):
        """The parametric ``(data, state[, fpt_bound])`` solo runner."""
        return self._get("solo", spec, cfg, pad, use_fpt)

    def batch_plane(self, spec, cfg, pad: int, use_fpt: bool):
        """The parametric ``(datas, worker, done[, fpt_bounds])`` runner."""
        return self._get("batch", spec, cfg, pad, use_fpt)

    # -- warm/cold accounting --------------------------------------------------

    def note(
        self, kind: str, spec, cfg, pad: int, use_fpt: bool, shape: tuple
    ) -> bool:
        """Record one plane invocation's full signature (plane key + shape
        tuple); True if it was warm."""
        key = (self._plane_key(kind, spec, cfg, pad, use_fpt), shape)
        warm = key in self._shapes
        if warm:
            self.hits += 1
        else:
            self.misses += 1
            self._shapes.add(key)
        return warm

    def stats(self) -> CacheStats:
        return CacheStats(
            hits=self.hits,
            misses=self.misses,
            planes=len(self._planes),
            shapes=len(self._shapes),
        )
