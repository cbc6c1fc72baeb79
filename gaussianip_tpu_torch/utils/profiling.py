"""Tracing of the port:
  * span(name): a named span at a layer boundary of a step. It records
    only while a torch profiler runs (`torch.profiler.profile`, `trace`
    below) and the current CUDA stream captures no graph (a replayed
    graph runs kernels, not spans); otherwise it is a check or two and
    nothing else;
  * spans(): the recorded spans with their device milliseconds, read once
    and emptied;
  * capturing(): whether the current CUDA stream is capturing a graph;
  * trace(logdir): a torch.profiler trace of a region (CPU, plus CUDA when
    a card is present), written to <logdir>/trace.json for Perfetto or
    chrome://tracing, the spans among its host ranges.

A span that records does three things: it opens a host range of the
profiler that is not a user annotation (`_RecordFunctionFast`: a user
annotation would also put a row of its name among the device's
operations), records a CUDA event at entry and at exit on the current
stream when its device is a card, and keeps a record of its name, its
parent, the step index, its host interval on `time.time_ns()` (the clock
of the profiler's host and device rows) and its events. Elapsed times are
read only in `spans()`, never inside a step. Spans open and close on one
thread; a span's step index and device default to its parent's.

The backward runs on autograd's own thread, where no host range of the
caller's can close, so a `backward` span is split by an event instead:
`span("backward", split=(t, before, after))` hooks the tensor t (the
render's output) and records an event when its gradient is complete, which
divides the span into the records `before` (the loss side's backward) and
`after` (t's producer's backward). Autograd runs each node on its forward's
stream, so the events fall in one stream order.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# the records kept between two reads; the oldest go first beyond it
MAX_SPANS = 4096

_OFF = contextlib.nullcontext()


class _Record(NamedTuple):
    name: str
    parent: Optional[str]
    step: Optional[int]
    start_ns: int
    end_ns: int
    events: Optional[tuple]  # (device, start event, end event) on a card


_records: deque = deque(maxlen=MAX_SPANS)
_open: list = []


class _Span:
    def __init__(self, name: str, step, device, split):
        parent = _open[-1] if _open else None
        self.name = name
        self.parent = parent.name if parent else None
        self.step = step if step is not None or parent is None \
            else parent.step
        self.device = (torch.device(device) if device is not None
                       else parent.device if parent else None)
        self.split = split
        self.hook = self.cut = None

    def _event(self):
        if self.device is None or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _at_cut(self, grad):
        self.cut = (time.time_ns(), self._event())

    def __enter__(self):
        _open.append(self)
        if self.split is not None and self.split[0].requires_grad:
            self.hook = self.split[0].register_hook(self._at_cut)
        self.start_ns = time.time_ns()
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.ev0 = self._event()
        return self

    def __exit__(self, *exc):
        ev1 = self._event()
        self.range.__exit__(*exc)
        end = time.time_ns()
        _open.pop()
        if self.hook is not None:
            self.hook.remove()
        ev = lambda a, b: None if a is None else (self.device, a, b)
        _records.append(_Record(self.name, self.parent, self.step,
                                self.start_ns, end, ev(self.ev0, ev1)))
        if self.cut is not None:
            at, cut_ev = self.cut
            before, after = self.split[1:]
            _records.append(_Record(before, self.name, self.step,
                                    self.start_ns, at, ev(self.ev0, cut_ev)))
            _records.append(_Record(after, self.name, self.step, at, end,
                                    ev(cut_ev, ev1)))
        return False


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def span(name: str, step: Optional[int] = None, device=None, split=None):
    """A context manager: the span `name` while a torch profiler runs and
    the current CUDA stream captures no graph, and nothing otherwise.
    `step` (the step index) and `device` (events are recorded on a CUDA
    device) default to the enclosing span's. `split`
    (tensor, before, after) divides the span where the tensor's gradient
    is complete (see the module's docstring)."""
    if not _profiler_enabled() or capturing():
        return _OFF
    return _Span(name, step, device, split)


def spans() -> list:
    """The recorded spans in the order they opened, and an empty table.
    Each is a dict: name, parent (its name, or None), step, start_ns and
    end_ns (`time.time_ns()`), device_ms (the events' elapsed time; None
    off a card). Synchronises each card once when any span has events."""
    got = sorted(_records, key=lambda r: r.start_ns)
    _records.clear()
    for d in {r.events[0] for r in got if r.events is not None}:
        torch.cuda.synchronize(d)
    return [{"name": r.name, "parent": r.parent, "step": r.step,
             "start_ns": r.start_ns, "end_ns": r.end_ns,
             "device_ms": None if r.events is None
             else r.events[1].elapsed_time(r.events[2])} for r in got]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed region -> <logdir>/trace.json.
    Yields the profiler (key_averages() for sums by operator)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
