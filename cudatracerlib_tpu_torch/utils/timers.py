"""Timing, and the port's span recorder (port of
``cudatracerlib_tpu/utils/timers.py``; the reference's ``Base/Timer.h``
InstructionTimer / PerformanceTimer scoped block profiler).

``RECORDER``, a PerformanceTimer, records the spans that the tracers open at
their stage boundaries (``span``, ``RECORDER.pass_block``). It is on exactly
while a ``torch.profiler`` session records: run a pass under the profiler to
turn it on. When it is off a span costs one check and a shared null context.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

_recording = torch._C._autograd._profiler_enabled
_NULL = nullcontext()


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _now() -> float:
    """The host clock after the card's queued work has finished."""
    if _cuda_in_use():
        torch.cuda.synchronize()
    return time.perf_counter()


class InstructionTimer:
    def __init__(self):
        self.start()

    def start(self):
        self._t0 = _now()
        return self

    def elapsed(self) -> float:
        return _now() - self._t0


class Span:
    """One recorded span: its name, host start and end (``perf_counter_ns``),
    the span open around it, the pass it belongs to (the request), and on
    the card a timing event pair on the stream it was opened on."""

    __slots__ = ("name", "parent", "pass_id", "t0_ns", "t1_ns", "_events", "_device_s")

    def __init__(self, name, parent, pass_id, events):
        self.name, self.parent, self.pass_id = name, parent, pass_id
        self._events, self._device_s = events, None
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = None

    def device_s(self) -> float:
        """Seconds on the device's clock between the span's events (resolved
        on the first call; the host clock's where no events were recorded)."""
        if self._device_s is None:
            if self._events is None:
                self._device_s = (self.t1_ns - self.t0_ns) * 1e-9
            else:
                self._events[1].synchronize()
                self._device_s = self._events[0].elapsed_time(self._events[1]) * 1e-3
                self._events = None
        return self._device_s


class PerformanceTimer:
    """Scoped block profiler. ``block(name)`` is a span: it enters
    ``torch.profiler.record_function(name)``, so the span and the kernels it
    launches sit in the profiler's trace on the device trace's clock, and on
    the card records a timing-enabled ``torch.cuda.Event`` pair on the
    current stream, with no synchronize. It adds the block's host seconds to
    ``totals`` and one to ``counts``; ``device_totals()`` sums the device
    seconds of the spans, resolved when asked.

    ``spans`` keeps, in the order they opened, at most ``MAX_SPANS`` spans
    of the latest stretch of traced passes: ``pass_block`` starts a new
    stretch at the first traced pass after an untraced one.
    ``first_pass_s`` is the host seconds of the newest tracer's first pass,
    recorded whether or not spans are."""

    MAX_SPANS = 1 << 16

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = []
        self.first_pass_s = None
        self._open = []
        self._pass_id = None
        self._in_stretch = False
        self._device_done = defaultdict(float)

    @contextmanager
    def block(self, name: str, pass_id=None):
        if pass_id is None:
            pass_id = self._pass_id
        kept = len(self.spans) < self.MAX_SPANS
        events = None
        if kept and _cuda_in_use():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        span = Span(name, self._open[-1] if self._open else None, pass_id, events)
        if kept:
            self.spans.append(span)
        self._open.append(span)
        outer_pass, self._pass_id = self._pass_id, pass_id
        try:
            with torch.profiler.record_function(name):
                if events:
                    events[0].record()
                try:
                    yield span
                finally:
                    if events:
                        events[1].record()
        finally:
            span.t1_ns = time.perf_counter_ns()
            self._open.pop()
            self._pass_id = outer_pass
            self.totals[name] += (span.t1_ns - span.t0_ns) * 1e-9
            self.counts[name] += 1

    def pass_block(self, pass_id):
        """The span of one pass, ``ctl.pass``, while a profiler records;
        otherwise the null context, and the next traced pass starts a new
        stretch."""
        if not _recording():
            self._in_stretch = False
            return _NULL
        if not self._in_stretch:
            self._in_stretch = True
            self._retire()
        return self.block("ctl.pass", pass_id)

    def _retire(self):
        """Move the kept spans' device seconds into the totals and forget
        them."""
        for s in self.spans:
            if s.t1_ns is not None:
                self._device_done[s.name] += s.device_s()
        self.spans = []

    def device_totals(self) -> dict:
        out = defaultdict(float, self._device_done)
        for s in self.spans:
            if s.t1_ns is not None:
                out[s.name] += s.device_s()
        return dict(out)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot:.3f}s total, {n} calls, {tot / n * 1e3:.2f} ms avg")
        return "\n".join(lines)


RECORDER = PerformanceTimer()


def span(name: str):
    """A span of the recorder while a profiler records; otherwise the shared
    null context."""
    if not _recording():
        return _NULL
    return RECORDER.block(name)
