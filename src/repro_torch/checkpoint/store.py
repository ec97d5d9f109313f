"""Checkpoint store: atomic save/restore of named arrays, with async writes.

The port of ``repro/checkpoint/store.py``, on the same files:

Layout:  <dir>/step_<N>/  arrays.npz  (the flattened tree's leaves)
                          manifest.msgpack  (leaf keys, step, extra
                                             metadata, per-array CRC32)
         <dir>/step_<N>.prev/   the previous generation of the same step
                                (kept, not clobbered, on overwrite)

* **atomic**: written to a unique ``step_<N>.<rand>.tmp`` dir, then swapped
  into place under a process-wide lock: a crash mid-write never corrupts
  the latest checkpoint, and concurrent writers of one step are
  last-writer-wins.  Overwriting a step rotates it to ``step_<N>.prev``;
* **checked**: the manifest records a CRC32 per array, so bit-rot inside a
  structurally valid npz is detected at load (and the solve loader falls
  back to the previous good generation, see :mod:`repro_torch.checkpoint.solve`);
* **retried**: save/load take an optional :class:`RetryPolicy` (bounded
  exponential backoff, injectable sleep and rng) and an optional
  ``fault_hook(op)`` called at the top of every I/O attempt;
* **async**: ``save_checkpoint(..., blocking=False)`` copies to host memory
  synchronously and writes on a daemon thread.

A tree is a nested ``dict`` of tensors and numpy arrays.  Each leaf is
keyed as the JAX package keys a dict leaf: its path parts ``[{k!r}]``
joined by ``/``, dict keys in sorted order, so ``{"b": {"c": x}}`` is
stored under ``"['b']/['c']"`` and a file written by either package reads
in the other.  Tensors go to the host with ``.detach().cpu().numpy()``.
The manifest is MessagePack, written and read by the port's own codec
(:mod:`repro_torch.checkpoint._msgpack`).
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import tempfile
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

_PENDING: list[threading.Thread] = []
# Serializes the final tmp->step_<N> swap across writer threads; the bulk
# np.savez I/O stays outside the lock so async saves still overlap compute.
_SWAP_LOCK = threading.Lock()
# Process umask, read once at import (before writer threads exist: the
# os.umask read is a racy set/restore).
_UMASK = os.umask(0)
os.umask(_UMASK)


# -- bounded retry/backoff -----------------------------------------------------


@dataclasses.dataclass(eq=False)
class RetryPolicy:
    """Bounded exponential backoff for checkpoint-store I/O.

    ``sleep`` and ``rng`` are injectable: tests pass a virtual clock and a
    seeded ``random.Random`` so retry trajectories are deterministic; the
    defaults are ``time.sleep`` and a fixed seed (jitter only decorrelates
    writers)."""

    max_attempts: int = 4
    base_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.25
    sleep: Callable[[float], None] = time.sleep
    rng: Optional[random.Random] = None
    retry_on: tuple = (OSError,)
    retries: int = 0  # attempts beyond the first, across all wrapped calls

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.rng is None:
            self.rng = random.Random(0)

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): exponential with
        multiplicative jitter in ``[1, 1 + jitter]``."""
        return (
            self.base_s
            * (self.multiplier ** attempt)
            * (1.0 + self.jitter * self.rng.random())
        )


def call_with_retry(fn: Callable[[], Any], policy: Optional[RetryPolicy],
                    *, what: str = "checkpoint I/O") -> Any:
    """Run ``fn`` under ``policy`` (None = a single attempt).  Only
    ``policy.retry_on`` exceptions are retried: corrupt content
    (CheckpointError) is not an I/O flake and falls through to the
    generation fallback instead."""
    if policy is None:
        return fn()
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except policy.retry_on as e:
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            delay = policy.backoff_s(attempt)
            policy.retries += 1
            warnings.warn(
                f"{what} failed (attempt {attempt + 1}/"
                f"{policy.max_attempts}): {e}; retrying in {delay:.3f}s",
                RuntimeWarning,
                stacklevel=2,
            )
            policy.sleep(delay)
    raise last


# -- the tree <-> named leaves -------------------------------------------------


def _leaves(tree, path=()):
    """(path parts, leaf) pairs of a nested dict, dict keys sorted as the
    JAX package flattens them; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif tree is not None:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> list[tuple[str, np.ndarray]]:
    return [("/".join(path), _host(leaf)) for path, leaf in _leaves(tree)]


def array_checksum(arr: np.ndarray) -> int:
    """CRC32 over an array's raw bytes (the manifest integrity record)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    extra: Optional[dict] = None,
    *,
    blocking: bool = True,
    retry: Optional[RetryPolicy] = None,
    fault_hook: Optional[Callable[[str], None]] = None,
) -> str:
    """Snapshot ``tree`` (a nested dict of tensors/arrays) + ``extra``
    metadata; returns the ``step_<N>`` path."""
    payload = dict(_flatten(tree))
    meta = {
        "step": int(step),
        "keys": list(payload.keys()),
        "checksums": {k: array_checksum(v) for k, v in payload.items()},
        "extra": extra or {},
    }

    def write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step}")

        def attempt():
            if fault_hook is not None:
                fault_hook("write")
            # a unique tmp dir per writer: concurrent saves of one step
            # never share a path, and a failed attempt's debris never
            # blocks the retry
            tmp = tempfile.mkdtemp(
                prefix=f"step_{step}.", suffix=".tmp", dir=directory
            )
            # mkdtemp creates 0700; give the renamed step_<N> dir the
            # umask's default permissions
            os.chmod(tmp, 0o777 & ~_UMASK)
            try:
                np.savez(os.path.join(tmp, "arrays.npz"), **payload)
                with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
                    f.write(_msgpack.packb(meta))
                with _SWAP_LOCK:
                    if os.path.exists(final):
                        # keep the previous generation of this step: one
                        # bad write must never destroy the last good state
                        prev = final + ".prev"
                        shutil.rmtree(prev, ignore_errors=True)
                        os.rename(final, prev)
                    os.rename(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise

        call_with_retry(attempt, retry, what=f"checkpoint write step_{step}")

    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    return os.path.join(directory, f"step_{step}")


def wait_for_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def _step_of(name: str) -> Optional[int]:
    """step_<N> -> N; tmp dirs, .prev generations and junk -> None."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        s for s in (_step_of(name) for name in os.listdir(directory))
        if s is not None
    ]
    return max(steps) if steps else None


def generation_dirs(directory: str) -> list:
    """Candidate checkpoint dirs, most recent first: every ``step_<N>``
    in descending step order, each followed by its retained
    ``step_<N>.prev`` generation.  The solve loader walks this list when
    the newest generation turns out corrupt."""
    if not os.path.isdir(directory):
        return []
    steps = sorted(
        {
            s for s in (_step_of(name) for name in os.listdir(directory))
            if s is not None
        },
        reverse=True,
    )
    out = []
    for s in steps:
        p = os.path.join(directory, f"step_{s}")
        if os.path.isdir(p):
            out.append(p)
        if os.path.isdir(p + ".prev"):
            out.append(p + ".prev")
    return out


def verify_checksums(manifest: dict, arrays: dict, *, where: str) -> None:
    """Compare loaded arrays against the manifest's CRC32 record; raises
    ``ValueError`` naming the first mismatching array.  Manifests written
    before checksums existed verify vacuously."""
    sums = manifest.get("checksums") or {}
    for key, expected in sums.items():
        if key in arrays and array_checksum(arrays[key]) != expected:
            raise ValueError(
                f"checksum mismatch for array {key!r} in {where} — "
                f"the checkpoint is corrupt (bit-rot or a torn write)"
            )


def _as_template(arr: np.ndarray, leaf, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` with ``leaf``'s dtype.  Words stored
    as uint32 enter an int32 template with the same bits."""
    if isinstance(leaf, torch.Tensor):
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
    elif hasattr(leaf, "dtype"):
        np_dtype = np.dtype(leaf.dtype)
    else:
        np_dtype = arr.dtype
    return torch.from_numpy(np.array(arr, dtype=np_dtype)).to(device)


def restore_checkpoint(
    directory: str,
    template: Any,
    step: Optional[int] = None,
    *,
    device=None,
    retry: Optional[RetryPolicy] = None,
    fault_hook: Optional[Callable[[str], None]] = None,
):
    """Restore into the structure of ``template`` (a nested dict): each
    leaf comes back as a tensor on ``device`` (None: the card) with the
    template leaf's dtype.

    Returns (tree, step, extra)."""
    from repro_torch.api.session import resolve_device

    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step}")

    def attempt():
        if fault_hook is not None:
            fault_hook("read")
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            meta = _msgpack.unpackb(f.read())
        with np.load(os.path.join(path, "arrays.npz")) as z:
            raw = {k: z[k] for k in z.files}
        return meta, raw

    meta, raw = call_with_retry(
        attempt, retry, what=f"checkpoint read step_{step}"
    )
    verify_checksums(meta, raw, where=path)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (f"[{k!r}]",)) for k, v in tree.items()}
        if tree is None:
            return None
        return _as_template(raw["/".join(path)], tree, dev)

    return build(template), meta["step"], meta["extra"]
