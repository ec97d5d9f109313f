"""The program's own spans (``repro_torch.telemetry``), as the per-layer
readers of ``"source": "program_span"`` take them.

A ``torch.profiler`` session switches the program's recorder on, so in a
traced run the spans recorded are those of the profiled step
(``observe.TRACE_CHUNK``); an untraced run records none.  A checkout whose
program has no recorder gives nothing, and its readers return None.
"""


def recorded() -> list:
    """Every span the program recorded in this process, oldest first."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return []
    return telemetry.spans()


def stream_ms_per_superstep(names: tuple):
    """The stream time (ms) of the spans named in ``names``, summed and
    divided by the number of ``plane.superstep`` spans; None without one."""
    spans = recorded()
    steps = sum(1 for s in spans if s.name == "plane.superstep")
    if not steps:
        return None
    return sum(s.stream_ms for s in spans if s.name in names) / steps
