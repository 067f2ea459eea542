"""Share of the traced window in which no device activity ran (the
union of kernel, copy and set intervals against the window), in %."""

from benchmark import devtrace

UNIT = "%"
TRACE = True


def read(run):
    if run.events is None or not devtrace.in_window(run.events):
        return None
    w = devtrace.window_ns(run.events)
    return 100.0 * (1.0 - devtrace.busy_ns(run.events) / w) if w > 0 else None
