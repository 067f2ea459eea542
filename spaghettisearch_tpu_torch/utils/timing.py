"""Structured timing/tracing.

The reference only has ad-hoc wall-clock prints (e.g. crawler/crawler.go:118,126,
cmd/server/server.go:46-50). Here tracing is a first-class module: nested spans
with wall-clock durations, queryable counters, and an optional hook into
torch.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


#: what Tracer.range returns while no profiler records (shared, reusable)
_NO_RANGE = contextlib.nullcontext()


@dataclass
class Tracer:
    """Thread-safe span aggregator and counters. While a torch.profiler
    records, every span and range is also a range on the profiler's host
    timeline, on the clock of its device activities, so the device work a
    block launched can be credited to it."""

    stats: dict[str, SpanStats] = field(default_factory=lambda: defaultdict(SpanStats))
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @staticmethod
    def range(name: str):
        """A profiler range around a block while a profiler records, else a
        no-op; nothing is aggregated (for device stages, whose host time is
        an asynchronous launch). The range has the scope of an operator,
        not of a user annotation, so the profiler makes no copy of it on
        the device's timeline: the device timeline holds only the work."""
        if _autograd_profiler._is_profiler_enabled:
            return _RecordFunctionFast(name)
        return _NO_RANGE

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with self.range(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats[name].add(dt)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def report(self) -> dict[str, dict[str, float]]:
        """Spans (count, total_s, mean_ms, max_ms), then counters (count)."""
        with self._lock:
            out = {
                name: {
                    "count": s.count,
                    "total_s": round(s.total_s, 6),
                    "mean_ms": round(1e3 * s.total_s / max(s.count, 1), 3),
                    "max_ms": round(1e3 * s.max_s, 3),
                }
                for name, s in sorted(self.stats.items())
            }
            out.update((name, {"count": c}) for name, c in sorted(self.counters.items()))
            return out

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()
            self.counters.clear()


#: Process-wide default tracer.
TRACER = Tracer()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace around a block (host activity, and
    the CUDA kernels when CUDA is present); writes a Chrome trace file into
    `logdir` when the block exits."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
