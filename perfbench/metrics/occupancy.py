"""The share of the plane's lane-supersteps in the window that served an
unfinished instance: the lanes' own superstep counts (each chunk's
``rounds`` growth) over supersteps × lanes.  A lane whose instance finishes
inside a chunk idles for the rest of it."""


def read(obs):
    paid = sum(c["ran"] * c["lanes"] for c in obs["chunks"])
    return 100.0 * sum(c["busy"] for c in obs["chunks"]) / paid if paid else None
