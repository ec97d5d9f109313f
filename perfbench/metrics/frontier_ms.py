"""The frontier's stream time per superstep in the profiled step: the
program's ``explore.pop`` and ``explore.push`` spans (each explore round's
pop of the deepest tasks, and the children's concatenation and
``push_many``), over its ``plane.superstep`` spans."""

from perfbench import spans


def read(obs):
    return spans.stream_ms_per_superstep(("explore.pop", "explore.push"))
