"""Task-record codecs (paper §4.3) and the CRC32 checks of stored records.

The port of ``repro/core/encoding.py``, numpy only, byte for byte the JAX
package's records: each codec's record width and ``pad_words`` (the payload
the data plane accounts for on top of the frontier's native (mask, sol,
depth) record), ``encode``/``decode`` of a :class:`Task`, and the CRC32
word the cold tier and checkpoints append to a record.

*Optimized encoding*: a task is the surviving-vertex bitset plus the
partial solution, 2W + 1 words; every worker holds the original graph.
*Basic encoding*: the induced subgraph's n·W adjacency words travel with
every task, so it decodes without the graph.

Records are uint32 numpy arrays.  The device frontier keeps its packed
words as int32 with the same bits: convert with ``.view(np.uint32)``, never
by value.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.graphs.bitgraph import BitGraph, n_words, unpack_mask
from repro_torch.problems.base import RECORD_FIELDS


@dataclasses.dataclass(frozen=True)
class Task:
    """A search-tree node: induced-subgraph mask + partial solution + depth."""

    mask: np.ndarray  # (W,) uint32 -- vertices still in the instance
    sol_mask: np.ndarray  # (W,) uint32 -- vertices already in the solution
    depth: int

    def key(self) -> tuple:
        return (self.mask.tobytes(), self.sol_mask.tobytes(), self.depth)


DEFAULT_RECORD_FIELDS = RECORD_FIELDS


def resolve_record_words(fields, n: int, W: int) -> int:
    """Total u32 words of a record schema.  Widths are symbolic: "W" (one
    packed bitset), "n*W" (an adjacency payload) or a literal int."""
    total = 0
    for _, width in fields:
        if width == "W":
            total += W
        elif width == "n*W":
            total += n * W
        elif isinstance(width, int):
            total += width
        else:
            raise ValueError(f"unknown record-field width {width!r}")
    return total


class OptimizedCodec:
    """n-bit-mask encoding: the problem's record schema verbatim (2W + 1
    words for the native layout).  A schema starts with the native triple;
    the fields after it ride as zero-filled extra payload words."""

    name = "optimized"

    def __init__(self, n: int, fields=DEFAULT_RECORD_FIELDS):
        if tuple(fields[:3]) != tuple(DEFAULT_RECORD_FIELDS):
            raise ValueError(
                f"record schema must start with the native "
                f"{DEFAULT_RECORD_FIELDS} triple, got {tuple(fields[:3])}"
            )
        self.n = n
        self.W = n_words(n)
        self.fields = tuple(fields)

    @property
    def record_words(self) -> int:
        return resolve_record_words(self.fields, self.n, self.W)

    @property
    def record_bytes(self) -> int:
        return 4 * self.record_words

    @property
    def native_words(self) -> int:
        return resolve_record_words(DEFAULT_RECORD_FIELDS, self.n, self.W)

    @property
    def pad_words(self) -> int:
        """Payload words over the frontier's native record — what the data
        plane accounts for per task so it reports this codec's wire size."""
        return self.record_words - self.native_words

    def _extra_zeros(self) -> np.ndarray:
        extra = resolve_record_words(self.fields[3:], self.n, self.W)
        return np.zeros(extra, dtype=np.uint32)

    def encode(self, task: Task) -> np.ndarray:
        return np.concatenate(
            [
                task.mask,
                task.sol_mask,
                np.array([task.depth], dtype=np.uint32),
                self._extra_zeros(),
            ]
        ).astype(np.uint32)

    def decode(self, rec: np.ndarray, graph: BitGraph | None = None) -> Task:
        W = self.W
        return Task(
            mask=rec[:W].astype(np.uint32),
            sol_mask=rec[W : 2 * W].astype(np.uint32),
            depth=int(rec[2 * W]),
        )


class BasicCodec(OptimizedCodec):
    """Adjacency encoding: the induced subgraph's rows, n·W words, ahead of
    the record schema ((n + 2)·W + 1 words for the native layout)."""

    name = "basic"

    @property
    def record_words(self) -> int:
        return self.n * self.W + super().record_words

    def encode(self, task: Task, graph: BitGraph) -> np.ndarray:
        sub_adj = (graph.adj & task.mask[None, :]).astype(np.uint32)
        # rows outside the mask are zero
        inside = unpack_mask(task.mask, self.n)
        sub_adj = np.where(inside[:, None], sub_adj, 0).astype(np.uint32)
        return np.concatenate(
            [
                sub_adj.reshape(-1),
                task.mask,
                task.sol_mask,
                np.array([task.depth], dtype=np.uint32),
                self._extra_zeros(),
            ]
        ).astype(np.uint32)

    def decode(self, rec: np.ndarray, graph: BitGraph | None = None) -> Task:
        n, W = self.n, self.W
        off = n * W
        return Task(
            mask=rec[off : off + W].astype(np.uint32),
            sol_mask=rec[off + W : off + 2 * W].astype(np.uint32),
            depth=int(rec[off + 2 * W]),
        )


CODECS = {"optimized": OptimizedCodec, "basic": BasicCodec}


def known_codecs() -> list:
    return sorted(CODECS)


def make_codec(name: str, n: int, problem=None):
    """Build a codec for ``problem``'s record schema (default layout when
    omitted); unknown names raise a ``ValueError`` listing the known ones."""
    if name not in CODECS:
        raise ValueError(
            f"unknown codec {name!r}; known codecs: {', '.join(known_codecs())}"
        )
    fields = (
        problem.record_fields if problem is not None else DEFAULT_RECORD_FIELDS
    )
    return CODECS[name](n, fields)


# -- payload integrity --------------------------------------------------------
#
# The cold tier and the checkpoint store carry records through host memory
# and disk, where corruption must be detected, never searched on.  A record
# is "checked" by one trailing CRC32 word over its payload; CRC32 is linear,
# so every single-bit flip, in the checksum word too, is caught.  The word
# is integrity metadata, not wire payload: ``record_words``/``record_bytes``
# are unchanged.


class PayloadCorruptionError(RuntimeError):
    """A checked task record failed checksum verification."""


def payload_checksum(words) -> int:
    """CRC32 (as uint32) over a u32 word array's raw bytes."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def checked_record(rec: np.ndarray) -> np.ndarray:
    """``rec`` (record_words,) -> (record_words + 1,) with a trailing
    CRC32 word."""
    rec = np.asarray(rec, dtype=np.uint32)
    return np.concatenate(
        [rec, np.array([payload_checksum(rec)], dtype=np.uint32)]
    )


def verify_record(rec: np.ndarray) -> bool:
    """Does a checked record's trailing CRC32 word match its payload?"""
    rec = np.asarray(rec, dtype=np.uint32)
    return rec.size >= 1 and payload_checksum(rec[:-1]) == int(rec[-1])


def strip_record(rec: np.ndarray) -> np.ndarray:
    """Verify a checked record and return the bare payload words; raises
    :class:`PayloadCorruptionError` on mismatch."""
    rec = np.asarray(rec, dtype=np.uint32)
    if not verify_record(rec):
        raise PayloadCorruptionError(
            f"task record failed checksum verification "
            f"(got {int(rec[-1]) if rec.size else '<empty>'}, "
            f"expected {payload_checksum(rec[:-1]) if rec.size else '?'})"
        )
    return rec[:-1]
