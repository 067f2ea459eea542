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


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


@dataclass
class Tracer:
    """Thread-safe span aggregator."""

    stats: dict[str, SpanStats] = field(default_factory=lambda: defaultdict(SpanStats))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats[name].add(dt)

    def report(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": s.count,
                    "total_s": round(s.total_s, 6),
                    "mean_ms": round(1e3 * s.total_s / max(s.count, 1), 3),
                    "max_ms": round(1e3 * s.max_s, 3),
                }
                for name, s in sorted(self.stats.items())
            }

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()


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
