"""Task-record codecs (paper §4.3): names and record widths.

The part of ``repro/core/encoding.py`` the solve plane reads: each codec's
record width and ``pad_words``, the payload the data plane accounts for on
top of the frontier's native (mask, sol, depth) record.

*Optimized encoding*: a task is the surviving-vertex bitset plus the
partial solution, 2W + 1 words; every worker holds the original graph.
*Basic encoding*: the induced subgraph's n·W adjacency words travel with
every task.

Encoding and decoding records (and their CRC32 checks) wait for the port
of the cold tier and checkpoints (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from repro_torch.graphs.bitgraph import n_words
from repro_torch.problems.base import RECORD_FIELDS

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
    words for the native layout)."""

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
    def native_words(self) -> int:
        return resolve_record_words(DEFAULT_RECORD_FIELDS, self.n, self.W)

    @property
    def pad_words(self) -> int:
        """Payload words over the frontier's native record — what the data
        plane accounts for per task so it reports this codec's wire size."""
        return self.record_words - self.native_words


class BasicCodec(OptimizedCodec):
    """Adjacency encoding: n·W words on top of the record schema."""

    name = "basic"

    @property
    def record_words(self) -> int:
        return self.n * self.W + super().record_words


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
