"""Host time of retirement per lane retired in the profiled step: the
program's ``service.retire`` spans (the lanes' state fetched to the host,
each result extracted, the lanes freed) over the lanes they retired."""

from perfbench import spans


def read(obs):
    retired = [s for s in spans.recorded() if s.name == "service.retire"]
    lanes = sum(s.ids["lanes"] for s in retired)
    return sum(s.host_ms for s in retired) / lanes if lanes else None
