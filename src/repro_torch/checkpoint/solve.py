"""Durable solve plane: the ``SolveCheckpoint`` schema over the store.

The port of ``repro/checkpoint/solve.py``, with its file format, its
fingerprint and its error texts, so a checkpoint written by either package
resumes in the other.  :mod:`repro_torch.checkpoint.store` is the I/O layer
(atomic tmp-dir swap, npz + MessagePack manifest, async writes); this
module is the schema layer: what a checkpoint of a running solve contains
and when a resume is allowed.

A :class:`SolveCheckpoint` snapshots everything the host loop needs to
rebuild the exact device state at a chunk boundary:

* ``arrays``: the device state under stable names, as host numpy arrays in
  the JAX package's flat layout (packed words as uint32 with the bits of
  the port's int32 tensors): the worker state of a solo solve or the lane
  state of a batched or live plane, the batched instance data, FPT bounds,
  and the instance graphs themselves (so a resume needs only the
  checkpoint);
* ``rounds``: the host progress counter at the boundary (the engine has no
  host RNG: the donor salt is ``WorkerState.rounds`` and the Algorithm-7
  startup order is deterministic, so the arrays and this counter are the
  whole trajectory state);
* ``fingerprint``: a digest of every config knob that shapes the
  trajectory, the problem name and the instance graphs.  Resuming under
  another fingerprint would silently run a different solve, so it is
  refused (:func:`require_fingerprint`).  Post-trajectory knobs
  (``max_rounds``, the checkpoint knobs, simulator knobs) are left out:
  extending a budget on resume is legitimate.

Corrupt, truncated or half-written checkpoints surface as
:class:`CheckpointError` naming the path, never as a raw ``zipfile`` or
codec traceback, and never as a silently wrong resume.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack, store

SCHEMA_VERSION = 2

#: SolveConfig fields that determine the solve TRAJECTORY (branching
#: decisions, transfer schedule, stats): the fingerprint material.  Host
#: budget/durability knobs and simulator-only knobs are absent: changing
#: them on resume cannot change what the device computes.
TRAJECTORY_FIELDS = (
    "num_workers",
    "steps_per_round",
    "lanes",
    "policy",
    "codec",
    "packed_status",
    "skip_empty_transfer",
    "transfer_impl",
    "explore_impl",
    "donate_k",
    "chunk_rounds",
    "mode",
    "k",
    "capacity",
    "compact_threshold",
    "service_lanes",
    "admission",
    "tenant_max_lanes",
    # the hierarchical frontier memory changes which tasks live on the
    # device at any sync point, so its knobs are trajectory material
    "frontier_spill",
    "spill_watermarks",
    "spill_codec",
)


class CheckpointError(RuntimeError):
    """A checkpoint could not be read/validated, or a resume was refused."""


def graph_digest(g) -> str:
    """Content digest of one instance graph (n + packed adjacency)."""
    h = hashlib.sha256()
    h.update(f"n={int(g.n)};".encode())
    h.update(np.ascontiguousarray(np.asarray(g.adj, np.uint32)).tobytes())
    return h.hexdigest()


def config_fingerprint(kind: str, problem: str, cfg, graph_digests) -> str:
    """Digest of (checkpoint kind, problem, trajectory knobs, instances)."""
    knobs = {name: getattr(cfg, name) for name in TRAJECTORY_FIELDS}
    for name, v in knobs.items():
        if isinstance(v, tuple):
            knobs[name] = list(v)
    blob = json.dumps(
        {
            "schema": SCHEMA_VERSION,
            "kind": kind,
            "problem": problem,
            "knobs": knobs,
            "graphs": list(graph_digests),
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def require_fingerprint(ckpt: "SolveCheckpoint", expected: str, *, what: str) -> None:
    if ckpt.fingerprint != expected:
        raise CheckpointError(
            f"config-fingerprint mismatch resuming {what}: the checkpoint "
            f"was written under a different (problem, trajectory config, "
            f"instances) — resuming would not reproduce the original solve. "
            f"checkpoint fingerprint {ckpt.fingerprint[:12]}..., "
            f"current {expected[:12]}...; align the trajectory knobs "
            f"({', '.join(TRAJECTORY_FIELDS)}) and the instance graphs, or "
            f"start a fresh solve"
        )


# -- the schema ----------------------------------------------------------------


@dataclasses.dataclass
class SolveCheckpoint:
    """One resumable snapshot of a solve plane at a host-sync boundary.

    ``kind`` is ``"solo"`` (one worker state), ``"many"`` (the in-flight
    bucket's lane state + the results finalized so far) or ``"service"``
    (every live plane + the pending queue).  ``arrays`` maps stable names
    to host numpy arrays; ``meta`` holds the kind-specific rest."""

    kind: str
    problem: str
    config: dict
    fingerprint: str
    rounds: int
    arrays: dict
    meta: dict = dataclasses.field(default_factory=dict)

    # -- write -----------------------------------------------------------------

    def save(self, directory: str, step: int, *, blocking: bool = True,
             retry=None, fault_hook=None) -> str:
        """Atomic write through :func:`repro_torch.checkpoint.store.save_checkpoint`
        (unique tmp dir + rename: a kill mid-write never corrupts an
        existing step; overwriting a step keeps the previous generation)."""
        extra = {
            "schema": SCHEMA_VERSION,
            "kind": self.kind,
            "problem": self.problem,
            "config": self.config,
            "fingerprint": self.fingerprint,
            "rounds": int(self.rounds),
            "arrays": sorted(self.arrays),
            "meta": self.meta,
        }
        return store.save_checkpoint(
            directory, step, dict(self.arrays), extra, blocking=blocking,
            retry=retry, fault_hook=fault_hook,
        )

    # -- read ------------------------------------------------------------------

    @classmethod
    def load(cls, path: str, step: Optional[int] = None, *,
             retry=None, fault_hook=None) -> "SolveCheckpoint":
        """Load from a checkpoint DIRECTORY (latest step, or ``step=``) or
        directly from one ``.../step_<N>`` dir.  Corrupt/truncated data
        raises :class:`CheckpointError` naming the path; transient
        ``OSError`` I/O failures are retried under ``retry``."""
        directory, step = _resolve_step(path, step)
        return cls._load_step_dir(
            os.path.join(directory, f"step_{step}"),
            retry=retry, fault_hook=fault_hook,
        )

    @classmethod
    def _load_step_dir(cls, step_dir: str, *, retry=None,
                       fault_hook=None) -> "SolveCheckpoint":
        """Load one concrete step (or ``step_<N>.prev``) directory."""

        def attempt():
            if fault_hook is not None:
                fault_hook("read")
            with open(os.path.join(step_dir, "manifest.msgpack"), "rb") as f:
                manifest = _msgpack.unpackb(f.read(), strict_map_key=False)
            with np.load(os.path.join(step_dir, "arrays.npz")) as z:
                raw = {k: z[k] for k in z.files}
            return manifest, raw

        try:
            manifest, raw = store.call_with_retry(
                attempt, retry, what=f"checkpoint read {step_dir}"
            )
            store.verify_checksums(manifest, raw, where=step_dir)
        except FileNotFoundError as e:
            raise CheckpointError(
                f"incomplete checkpoint at {step_dir}: missing {e.filename}"
            ) from e
        except Exception as e:
            raise CheckpointError(
                f"corrupt or truncated checkpoint at {step_dir}: {e}"
            ) from e
        extra = manifest.get("extra") or {}
        if extra.get("schema") != SCHEMA_VERSION:
            raise CheckpointError(
                f"checkpoint at {step_dir} is not a solve checkpoint "
                f"(schema {extra.get('schema')!r}, want {SCHEMA_VERSION}) — "
                f"was it written by save_checkpoint directly?"
            )
        arrays = {}
        for name in extra["arrays"]:
            key = f"[{name!r}]"
            if key not in raw:
                raise CheckpointError(
                    f"corrupt checkpoint at {step_dir}: array {name!r} "
                    f"listed in the manifest but absent from arrays.npz"
                )
            arrays[name] = raw[key]
        return cls(
            kind=extra["kind"],
            problem=extra["problem"],
            config=extra["config"],
            fingerprint=extra["fingerprint"],
            rounds=int(extra["rounds"]),
            arrays=arrays,
            meta=extra.get("meta") or {},
        )

    @classmethod
    def load_latest_good(cls, path: str, *, expected_fingerprint=None,
                         what: str = "solve", retry=None,
                         fault_hook=None) -> "SolveCheckpoint":
        """Load the newest checkpoint generation that is intact (and, when
        ``expected_fingerprint`` is given, fingerprint-matching).

        Given a checkpoint DIRECTORY, candidate generations are walked most
        recent first (``step_<N>`` descending, each followed by its
        retained ``step_<N>.prev``); a corrupt or mismatching generation is
        skipped with a loud warning and the next one is tried.  Only when
        no good generation remains does the newest generation's error
        propagate, so a single-generation corruption fails exactly like
        :meth:`load`.  An explicit ``.../step_<N>`` path stays strict (no
        fallback): pointing at one concrete step asks for THAT state."""
        base = os.path.basename(os.path.normpath(path))
        if base.startswith("step_") and not base.endswith(".tmp"):
            ck = cls.load(path, retry=retry, fault_hook=fault_hook)
            if expected_fingerprint is not None:
                require_fingerprint(ck, expected_fingerprint, what=what)
            return ck
        candidates = store.generation_dirs(path)
        if not candidates:
            raise CheckpointError(f"no checkpoint found under {path}")
        errors = []
        for step_dir in candidates:
            try:
                ck = cls._load_step_dir(
                    step_dir, retry=retry, fault_hook=fault_hook
                )
                if expected_fingerprint is not None:
                    require_fingerprint(ck, expected_fingerprint, what=what)
            except CheckpointError as e:
                errors.append((step_dir, e))
                continue
            if errors:
                bad = "; ".join(f"{d}: {e}" for d, e in errors)
                warnings.warn(
                    f"resuming {what} from an OLDER checkpoint generation "
                    f"{step_dir} — newer generation(s) were corrupt or "
                    f"refused ({bad}); recent progress since that "
                    f"generation will be re-executed",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return ck
        raise errors[0][1]

    # -- graph round-trip ------------------------------------------------------

    def pack_graphs(self, tags, graphs) -> None:
        """Store instance graphs under ``graph/<tag>`` (+ per-tag n in meta)
        so a resume is self-contained."""
        ns = {}
        for tag, g in zip(tags, graphs):
            self.arrays[f"graph/{tag}"] = np.asarray(g.adj, np.uint32)
            ns[str(tag)] = int(g.n)
        self.meta["graph_ns"] = ns

    def unpack_graph(self, tag):
        from repro_torch.graphs.bitgraph import BitGraph

        return BitGraph(
            n=self.meta["graph_ns"][str(tag)],
            adj=np.asarray(self.arrays[f"graph/{tag}"], np.uint32),
        )

    def unpack_graphs(self) -> list:
        """All stored graphs in tag order (tags are instance indices)."""
        tags = sorted(int(t) for t in self.meta["graph_ns"])
        return [self.unpack_graph(t) for t in tags]


def _resolve_step(path: str, step: Optional[int]):
    """(directory, step) from a checkpoint dir or a step_<N> subdir."""
    base = os.path.basename(os.path.normpath(path))
    if base.startswith("step_") and not base.endswith(".tmp"):
        if step is not None:
            raise ValueError("pass either a step_<N> path or step=, not both")
        try:
            return os.path.dirname(os.path.normpath(path)), int(base[5:])
        except ValueError:
            raise CheckpointError(f"malformed step directory name: {path}")
    if step is None:
        step = store.latest_step(path)
        if step is None:
            raise CheckpointError(f"no checkpoint found under {path}")
    return path, step


# -- EngineResult round-trip (solve_many finalizes results eagerly; the
# finalized ones ride in the checkpoint meta so a resume never re-extracts
# a lane that was already compacted away) --------------------------------------


def engine_result_to_dict(r) -> dict:
    d = dataclasses.asdict(r)
    if r.best_sol is not None:
        d["best_sol"] = [int(w) for w in np.asarray(r.best_sol, np.uint32)]
    return d


def engine_result_from_dict(d: dict):
    """An :class:`~repro_torch.core.engine.EngineResult` from either
    package's dict: the port's fields are taken, the rest (the JAX
    package's spill counters) ignored; ``reduce_sweeps``, the port's own,
    is 0 when the dict has none."""
    from repro_torch.core.engine import EngineResult

    known = {f.name for f in dataclasses.fields(EngineResult)}
    kw = {k: v for k, v in d.items() if k in known}
    sol = kw.get("best_sol")
    kw["best_sol"] = None if sol is None else np.asarray(sol, np.uint32)
    return EngineResult(**kw)


# -- ProblemData (de)serialization --------------------------------------------
#
# The JAX package's batched ProblemData is (n, adj, word_idx, bit_idx); the
# port's is (n, adj) with int32 words.  On disk both are the JAX layout.


def _bit_maps(n_max: int):
    v = np.arange(n_max, dtype=np.int32)
    return v // 32, (v % 32).astype(np.uint32)


def data_to_flat(data, prefix: str) -> dict:
    """Batched :class:`~repro_torch.problems.base.ProblemData` -> named
    arrays in the JAX layout: ``n`` (B,) int32, ``adj`` (B, n_max, W)
    uint32, and the bit maps ``word_idx`` (int32) and ``bit_idx`` (uint32)
    that ``n_max`` implies."""
    adj = data.adj.detach().cpu().numpy().view(np.uint32)
    word_idx, bit_idx = _bit_maps(adj.shape[-2])
    return {
        f"{prefix}.n": np.asarray(data.n, np.int32),
        f"{prefix}.adj": adj,
        f"{prefix}.word_idx": word_idx,
        f"{prefix}.bit_idx": bit_idx,
    }


def data_from_flat(flat: dict, prefix: str, device):
    """The batched instance data of :func:`data_to_flat` (either package's)
    on ``device``; refuses bit maps other than the ones ``n_max`` implies."""
    from repro_torch.problems.base import ProblemData

    adj = np.ascontiguousarray(np.asarray(flat[f"{prefix}.adj"], np.uint32))
    word_idx, bit_idx = _bit_maps(adj.shape[-2])
    if not (
        np.array_equal(flat[f"{prefix}.word_idx"], word_idx)
        and np.array_equal(flat[f"{prefix}.bit_idx"], bit_idx)
    ):
        raise CheckpointError(
            f"checkpoint arrays {prefix}.word_idx/bit_idx are not the bit "
            f"maps of n_max = {adj.shape[-2]}"
        )
    return ProblemData(
        n=np.array(flat[f"{prefix}.n"], np.int32),
        adj=torch.from_numpy(adj.view(np.int32).copy()).to(device),
    )
