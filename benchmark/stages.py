"""Device time by the port's own stages, from a torch.profiler trace.

The port marks its work with TRACER ranges that become profiler ranges
while a profiler records: the engine's dispatch (`engine.pack`,
`engine.upload`, `engine.launch`, `engine.phrase_match`) and the scoring
stages (`scoring.kernel`, `.hot`, `.counts`, `.fold`, `.csr`,
`.finalize` with `.sqd` inside it, `.topk`). `from_profiler` keeps, beside
what devtrace keeps, those host ranges and each device activity's link to
the host operation that launched it, and drops every device-side user
annotation. `stage_of` credits a device activity to the innermost program
range open on the launching thread when it was launched; the rest is
`unattributed`.

The accepted harness (run.py, devtrace.py) does not keep these yet, so
`stage_run` runs a cell through run.run_cell with the trace also reduced
here, and adds to its result:

    python -m benchmark.stages --workload <cell> --seed <n> --seconds <s> [--trace 0]

prints the result line with `breakdown.device_stages`, `breakdown.stage_ops`,
`breakdown.program_gaps` (idle gaps named by the program's ranges and by
`gc.gen<n>`, the garbage collector's pauses, which `gc_marker` makes ranges
of), `stages` (device ms per batch by stage group, the engine's spans and
the collector's pauses per window batch, from the trace), and in either
mode `spans` (the port's engine spans and counters over the run) and
`setup_spans` (the DeviceIndex build's parts and the kernels' builds, in
seconds, also on standard error).
"""

from __future__ import annotations

import bisect
import gc
from dataclasses import dataclass, field

from benchmark import devtrace

#: name prefixes of the port's TRACER spans and ranges
PROGRAM = ("engine.", "scoring.", "index.", "kernels.")
#: name prefix of the garbage collector's ranges (gc_marker)
GC = "gc."
UNATTRIBUTED = "unattributed"
#: stage groups reported as device ms per batch
GROUPS = {
    "device.finalize_ms": ("scoring.counts", "scoring.finalize", "scoring.sqd"),
    "device.hot_ms": ("scoring.hot",),
    "device.topk_ms": ("scoring.topk",),
    "device.kernel_ms": ("scoring.kernel",),
}


class Ranges:
    """Host ranges [(name, start, end)], properly nested, searchable for the
    innermost one holding a time."""

    def __init__(self, ranges):
        self.items = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [s for _, s, _ in self.items]
        self.reach, top = [], None  # the latest end among ranges up to i
        for _, _, e in self.items:
            top = e if top is None else max(top, e)
            self.reach.append(top)

    def innermost(self, t: int) -> str | None:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.reach[j] > t:
            name, s, e = self.items[j]
            if s <= t < e:
                return name
            j -= 1
        return None


@dataclass
class Stages(devtrace.Events):
    """devtrace's events plus the program's host ranges by thread, the host
    operations device work links to, and each device activity's link."""

    program: list[tuple[str, int, int, int]] = field(default_factory=list)  # name, tid, s, e
    ops: dict[int, tuple[int, int]] = field(default_factory=dict)  # correlation -> tid, start
    runtime: dict[int, int] = field(default_factory=dict)  # correlation -> start
    links: list[tuple[int, int]] = field(default_factory=list)  # per device: linked, own id

    def by_thread(self) -> dict[int, Ranges]:
        per: dict[int, list] = {}
        for name, tid, s, e in self.program:
            per.setdefault(tid, []).append((name, s, e))
        return {tid: Ranges(r) for tid, r in per.items()}


def _is_annotation(e) -> bool:
    """A user annotation (on the device: its copy on the device's timeline,
    which is no work); by name where the event has no flag for it."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    return e.name().startswith((devtrace.HOST_PREFIX,) + PROGRAM)


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel, ...);
    by name where the event does not give its activity type."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind())
        return "runtime" in kind or "driver" in kind
    return e.name().startswith("cu")


def from_profiler(prof) -> Stages:
    """The stopped torch.profiler.profile's events, reduced as devtrace does
    (the harness's `bench.*` host ranges; kernels, copies and sets on the
    device) with every device-side annotation dropped, plus the program's
    ranges and the launch links."""
    from torch.autograd import DeviceType

    out = Stages()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                out.device.append((name, *devtrace._times(e)))
                out.links.append((int(e.linked_correlation_id()), int(e.correlation_id())))
            continue
        start, end = devtrace._times(e)
        if _is_runtime(e):
            out.runtime[int(e.correlation_id())] = start
            continue
        if name.startswith((devtrace.HOST_PREFIX, GC)):
            out.host.append((name, start, end))
        elif name.startswith(PROGRAM):
            out.program.append((name, int(e.start_thread_id()), start, end))
        out.ops[int(e.correlation_id())] = (int(e.start_thread_id()), start)
    return out


def stage_of(ev: Stages) -> list[str]:
    """Per device activity (ev.device's order): the innermost program range
    that held its launch, on the launching thread, or UNATTRIBUTED. The
    launch is the host operation the activity links to, else its runtime
    call."""
    threads = ev.by_thread()
    every = Ranges([(n, s, e) for n, _, s, e in ev.program])
    out = []
    for linked, own in ev.links:
        name = None
        if linked in ev.ops:
            tid, t = ev.ops[linked]
            r = threads.get(tid)
            name = r.innermost(t) if r is not None else None
        elif own in ev.runtime:
            name = every.innermost(ev.runtime[own])
        out.append(name or UNATTRIBUTED)
    return out


def _clipped(ev: Stages):
    """(index into ev.device, start, end) of the activities in the window."""
    w = ev.window()
    if w is None:
        return []
    lo, hi = w
    return [(i, max(s, lo), min(e, hi)) for i, (_, s, e) in enumerate(ev.device)
            if e > lo and s < hi]


def device_stages(ev: Stages) -> dict[str, float]:
    """Device seconds in the window by stage, UNATTRIBUTED included: the
    values sum to the window's device time (devtrace.in_window)."""
    stage = stage_of(ev)
    acc: dict[str, int] = {}
    for i, s, e in _clipped(ev):
        acc[stage[i]] = acc.get(stage[i], 0) + (e - s)
    return {k: v / 1e9 for k, v in sorted(acc.items(), key=lambda kv: -kv[1])}


def stage_ops(ev: Stages, top: int = 6) -> dict[str, list]:
    """Per stage, the device activities that took most of its time."""
    stage = stage_of(ev)
    acc: dict[str, dict[str, int]] = {}
    for i, s, e in _clipped(ev):
        per = acc.setdefault(stage[i], {})
        k = devtrace.short_name(ev.device[i][0])
        per[k] = per.get(k, 0) + (e - s)
    return {st: [[k, v / 1e9] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:top]]
            for st, per in acc.items()}


def host_ranges(ev: Stages) -> Ranges:
    """The host ranges of either kind: the harness's (other than the
    window) and the program's."""
    return Ranges([r for r in ev.host if r[0] != devtrace.WINDOW]
                  + [(n, s, e) for n, _, s, e in ev.program])


def program_gaps(ev: Stages, top: int = 10) -> list[list]:
    """The longest idle stretches of the device, each named by the innermost
    host range of either kind at its middle (devtrace.idle_gaps names them
    by the harness's ranges alone)."""
    ranges = host_ranges(ev)
    ranked = sorted(devtrace.gaps(ev), key=lambda g: g[0] - g[1])[:top]
    return [[ranges.innermost((s + e) // 2) or "other", (e - s) / 1e9] for s, e in ranked]


def span_ms(ev: Stages, name: str, per: int) -> float | None:
    """Host milliseconds of a program span in the window, per `per` batches."""
    w = ev.window()
    if w is None or not per:
        return None
    total = sum(e - s for n, _, s, e in ev.program if n == name and s >= w[0] and e <= w[1])
    return total / 1e6 / per


def summary(ev: Stages, ms_per_batch: float) -> dict:
    """Device ms per batch of each stage group (its share of the window's
    device time times devtrace's device.ms_per_batch), the unattributed
    share, the engine's spans per window batch as the trace saw them, and
    the garbage collector's pauses in the window."""
    st = device_stages(ev)
    total = sum(st.values())
    out = {"unattributed_pct": 100.0 * st.get(UNATTRIBUTED, 0.0) / total if total else None}
    for metric, names in GROUPS.items():
        out[metric] = ms_per_batch * sum(st.get(n, 0.0) for n in names) / total if total else None
    w = ev.window()
    launches = sum(1 for n, _, s, e in ev.program
                   if n == "engine.launch" and w and s >= w[0] and e <= w[1])
    for name in ("engine.pack", "engine.upload", "engine.launch", "engine.phrase_match"):
        out[name.replace(".", "_") + "_ms"] = span_ms(ev, name, launches)
    pauses = [e - s for n, s, e in ev.host if n.startswith(GC) and w and s >= w[0] and e <= w[1]]
    out["gc_ms"] = sum(pauses) / 1e6 / launches if launches else None
    out["gc_pauses"] = len(pauses)
    out["gc_max_ms"] = max(pauses, default=0) / 1e6
    return out


def gc_marker():
    """A gc callback that makes each collection a profiler range,
    `gc.gen<n>`, while a profiler records: the pauses the harness's and the
    program's ranges cannot name."""
    from torch._C._profiler import _RecordFunctionFast

    open_ranges = []

    def mark(phase, info):
        if phase == "start":
            r = _RecordFunctionFast(f"{GC}gen{info['generation']}")
            r.__enter__()
            open_ranges.append(r)
        elif open_ranges:
            open_ranges.pop().__exit__(None, None, None)

    return mark


def stage_run(cell: dict, seed: int, seconds: float, device: str = "cuda",
              trace: bool = True):
    """run.run_cell, with a traced run's trace also reduced here (the
    result gains the stage split); either way the result gains the port's
    engine spans and counters (`spans`, the whole run's: warm-up and
    window) and `setup_spans`. -> (result, checks, Stages or None)."""
    from benchmark import run

    reduce, kept, mark = devtrace.from_profiler, [], gc_marker()

    def both(prof):
        kept.append(from_profiler(prof))
        return reduce(prof)

    devtrace.from_profiler = both
    gc.callbacks.append(mark)
    try:
        result, checks = run.run_cell(cell, seed, seconds, trace, device)
    finally:
        devtrace.from_profiler = reduce
        gc.callbacks.remove(mark)
    result["spans"], result["setup_spans"] = program_spans()
    if not kept:
        return result, checks, None
    ev = kept[0]
    result["breakdown"]["device_stages"] = device_stages(ev)
    result["breakdown"]["stage_ops"] = stage_ops(ev)
    result["breakdown"]["program_gaps"] = program_gaps(ev)
    ms = result["metrics"].get("device.ms_per_batch", {}).get("value")
    result["stages"] = summary(ev, ms) if ms is not None else None
    return result, checks, ev


def program_spans() -> tuple[dict, dict]:
    """The port's TRACER so far in this process: its engine spans and
    counters (as TRACER.report() gives them), and the seconds of its set-up
    spans (the DeviceIndex build's parts, the kernels' builds)."""
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    rep = TRACER.report()
    engine = {n: v for n, v in rep.items() if n.startswith("engine.")}
    setup = {n: v["total_s"] for n, v in rep.items()
             if n.startswith(("index.", "kernels.")) and "total_s" in v}
    return engine, setup


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run._cache_dirs()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    result, checks, _ = stage_run(run.load_cell(args.workload), args.seed, args.seconds,
                                  trace=bool(args.trace))
    print(json.dumps(result))
    print("setup spans: " + ", ".join(f"{k} {v:.2f}" for k, v in result["setup_spans"].items()),
          file=sys.stderr)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
