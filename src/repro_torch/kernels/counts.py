"""Launch counts of the hand-written kernels.

Each kernel wrapper adds one to its entry where it launches its kernel on
the card, and nowhere else (a CPU tensor that takes the plain version adds
nothing).  A run zeroes the counts before it drives a path and reads them
after, to show that the path really went through the kernels.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {}


def bump(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset() -> None:
    LAUNCHES.clear()


def snapshot() -> dict[str, int]:
    return dict(LAUNCHES)
