"""The plane's wall per superstep: the window's chunk walls (host clock,
each ending in the chunk's own read of ``done``) over the supersteps they
ran, leaving out the profiled chunk."""


def read(obs):
    chunks = [c for c in obs["chunks"] if not c["traced"]]
    ran = sum(c["ran"] for c in chunks)
    return 1e3 * sum(c["wall"] for c in chunks) / ran if ran else None
