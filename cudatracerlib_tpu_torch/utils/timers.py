"""Timing and counters (port of ``cudatracerlib_tpu/utils/timers.py``; the
reference's ``Base/Timer.h`` InstructionTimer / PerformanceTimer scoped
block profiler, and the TracerBase rays/s counters).

PyTorch returns before the card finishes, so every reading here first
waits for the card (``torch.cuda.synchronize()``) once CUDA is in use.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def _now() -> float:
    """The host clock after the card's queued work has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
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


class PerformanceTimer:
    """Scoped block profiler: accumulate wall time per named block
    (START_PERF_BLOCK equivalent is the `block` context manager)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def block(self, name: str):
        t0 = _now()
        try:
            yield
        finally:
            dt = _now() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: {tot:.3f}s total, {n} calls, {tot / n * 1e3:.2f} ms avg")
        return "\n".join(lines)


class RayCounter:
    """Host-side rays-traced accounting (the tracers' int64 device counters,
    read once per pass, feed add_pass)."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def add_pass(self, n_rays: int, seconds: float):
        self.rays += n_rays
        self.seconds += seconds

    @property
    def mrays_per_second(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6
