"""The center's stream time per superstep in the profiled step: the
program's ``center.status`` (pending, top depth, the packed word, the best
broadcast), ``center.match`` (the idle-to-donor matching and the donation
counts) and ``center.done`` (the exact-termination reduction) spans, over
its ``plane.superstep`` spans."""

from perfbench import spans


def read(obs):
    return spans.stream_ms_per_superstep(("center.status", "center.match", "center.done"))
