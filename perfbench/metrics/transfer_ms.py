"""The data plane's stream time per superstep in the profiled step: the
program's ``transfer.pop`` (the donors' ``pop_k_shallowest``) and
``transfer.push`` (the receivers' ``push_many`` and the transfer counters)
spans, over its ``plane.superstep`` spans."""

from perfbench import spans


def read(obs):
    return spans.stream_ms_per_superstep(("transfer.pop", "transfer.push"))
