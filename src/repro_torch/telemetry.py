"""Spans: named ranges at the layer boundaries of the port, on the device
trace's clock and in memory.

``span(name, device=None, **ids)`` is a context manager that the solve
plane, the service and the LM layers open around their work.  It is off by
default: it then returns one shared null context after a single check and
records nothing.  Two things switch it on:

* a ``torch.profiler`` session being active, so that inside any profiler
  trace the program's layers sit on the trace's own clock and every launch
  maps to its range through its correlation id;
* the body of :func:`recording`, the operator's switch for a live service
  with no profiler running.

While on, each span

* opens a ``torch.profiler.record_function(name)`` range (a
  ``user_annotation`` event in an exported trace) if a profiler is running
  (without one a range has no reader and costs ~9 µs of host time);
* appends a :class:`Span` to a bounded in-memory list when it closes: the
  name, the enclosing span's name, the ids (a ticket, a lane count, a plane
  key) and the host ``perf_counter_ns`` start and end;
* on a CUDA ``device``, records a start and an end ``torch.cuda.Event`` on
  the device's current stream at the span's start.  :attr:`Span.stream_ms` is the time between
  them, read lazily (after the plane's own read of ``done`` has
  synchronised, the events are complete).  On the CPU, where ops run
  synchronously, a span's stream time is its host interval.

A span's stream time includes any time inside the span when the device sat
idle, waiting for the host to enqueue that span's work: on a device that
the host keeps busy it is the span's device time, on a host-bound plane it
is more.

Spans stay in memory; :func:`spans` returns a copy of the records without
clearing them, so several readers can read one run, and whoever reads them
writes them out.  :func:`clear` empties the list.

  with telemetry.recording():
      svc.step()
  ms = sum(s.stream_ms for s in telemetry.spans() if s.name == "center.match")
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

MAX_SPANS = 1 << 17  # the newest spans kept; older ones are dropped

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclass(slots=True)
class Span:
    """One closed span.  ``parent`` is the name of the span open around it
    in the same thread (None at the top)."""

    name: str
    parent: str | None
    ids: dict
    start_ns: int
    end_ns: int
    events: tuple | None = field(default=None, repr=False)  # (start, end) CUDA events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def stream_ms(self) -> float:
        """Device-stream time between the span's start and end (host time
        on the CPU)."""
        if self.events is None:
            return self.host_ms
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Recorder:
    def __init__(self):
        self.records = collections.deque(maxlen=MAX_SPANS)
        self.depth = 0  # open recording() bodies, over all threads
        self.lock = threading.Lock()
        self.local = threading.local()  # each thread's stack of open span names


_REC = _Recorder()


class _Open:
    """The context of one span while it is open."""

    __slots__ = ("name", "device", "ids", "parent", "start_ns", "start_ev", "stream", "range")

    def __init__(self, name: str, device, ids: dict):
        self.name, self.device, self.ids = name, device, ids

    def __enter__(self):
        stack = _REC.local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start_ev = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.start_ev = torch.cuda.Event(enable_timing=True)
            self.start_ev.record(self.stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        events = None
        if self.start_ev is not None:
            end_ev = torch.cuda.Event(enable_timing=True)
            end_ev.record(self.stream)
            events = (self.start_ev, end_ev)
        if self.range is not None:
            self.range.__exit__(*exc)
        _REC.local.stack.pop()
        _REC.records.append(Span(self.name, self.parent, self.ids, self.start_ns, end_ns,
                                 events))
        return False


def span(name: str, device=None, **ids):
    """A span named ``name`` (with ``ids``) when the recorder is on, else a
    shared null context.  ``device`` is the device the span's work runs on
    (a ``torch.device``; stream time needs it on CUDA)."""
    if not (_REC.depth or _profiler_enabled()):
        return _NULL
    return _Open(name, device, ids)


@contextlib.contextmanager
def recording():
    """Record spans inside the body, with or without a profiler."""
    with _REC.lock:
        _REC.depth += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.depth -= 1


def spans() -> list:
    """A copy of the recorded spans, oldest first; the records stay."""
    return list(_REC.records)


def clear() -> None:
    """Drop every recorded span."""
    _REC.records.clear()
