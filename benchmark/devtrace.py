"""Reduction of a torch.profiler trace to what the per-layer metrics read.

The harness marks its own phases with record_function ranges named
"bench.*" (the window, and per batch the parse, the dispatch and the
fetch). `from_profiler` keeps those host ranges and every device activity
(kernels, copies, sets) as (name, start_ns, end_ns); the functions below
work on that plain form, so they can be tested on synthetic events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW = "bench.window"
HOST_PREFIX = "bench."


@dataclass
class Events:
    device: list[tuple[str, int, int]] = field(default_factory=list)
    host: list[tuple[str, int, int]] = field(default_factory=list)

    def window(self) -> tuple[int, int] | None:
        spans = [(s, e) for n, s, e in self.host if n == WINDOW]
        return spans[0] if spans else None


def _times(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = int(e.start_ns())
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") else int(e.end_ns()) - start
    else:
        start = int(e.start_us()) * 1000
        dur = int(e.duration_us()) * 1000
    return start, start + dur


def from_profiler(prof) -> Events:
    """Device activities and the harness's host ranges of a stopped
    torch.profiler.profile."""
    from torch.autograd import DeviceType

    out = Events()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(HOST_PREFIX):
            # a record_function range appears twice: on the host and as a
            # user annotation on the device's timeline, which is no work
            if e.device_type() != DeviceType.CUDA:
                out.host.append((name, *_times(e)))
        elif e.device_type() == DeviceType.CUDA:
            out.device.append((name, *_times(e)))
    return out


def in_window(ev: Events) -> list[tuple[str, int, int]]:
    """Device activities clipped to the traced window, by start."""
    w = ev.window()
    if w is None:
        return []
    lo, hi = w
    return sorted(
        (n, max(s, lo), min(e, hi)) for n, s, e in ev.device if e > lo and s < hi
    )


def busy_ns(ev: Events) -> int:
    """Length of the union of device activity inside the window."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(in_window(ev), key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window_ns(ev: Events) -> int:
    w = ev.window()
    return 0 if w is None else w[1] - w[0]


def gaps(ev: Events) -> list[tuple[int, int]]:
    """Idle stretches of the device inside the window."""
    w = ev.window()
    if w is None:
        return []
    out, t = [], w[0]
    for _, s, e in sorted(in_window(ev), key=lambda x: x[1]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w[1] > t:
        out.append((t, w[1]))
    return out


def host_at(ev: Events, t: int) -> str:
    """The innermost harness range (other than the window) holding time t."""
    best = None
    for n, s, e in ev.host:
        if n != WINDOW and s <= t < e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return best[0] if best else "other"


def short_name(name: str) -> str:
    name = name.split("(", 1)[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def base_name(name: str) -> str:
    """A kernel's own name: no arguments, template arguments or namespace."""
    return short_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


def device_ops(ev: Events, top: int = 10) -> list[list]:
    """The device activities that took most time, summed by name."""
    acc: dict[str, int] = {}
    for n, s, e in in_window(ev):
        k = short_name(n)
        acc[k] = acc.get(k, 0) + (e - s)
    ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]


def idle_gaps(ev: Events, top: int = 10) -> list[list]:
    """The longest idle stretches, each named by what the host was doing
    at its middle."""
    ranked = sorted(gaps(ev), key=lambda g: g[0] - g[1])[:top]
    return [[host_at(ev, (s + e) // 2), (e - s) / 1e9] for s, e in ranked]


def kernel(ev: Events, needle: str) -> tuple[int, float]:
    """(launches, seconds) of the kernels named `needle`."""
    n, total = 0, 0
    for name, s, e in in_window(ev):
        if base_name(name) == needle:
            n += 1
            total += e - s
    return n, total / 1e9
