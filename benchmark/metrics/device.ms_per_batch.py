"""Device milliseconds per batch: the summed duration of every device
activity (kernels, copies, sets) in the traced window, per batch of the
window."""

from benchmark import devtrace

UNIT = "ms"
TRACE = True


def read(run):
    if run.events is None or not run.batches:
        return None
    acts = devtrace.in_window(run.events)
    if not acts:
        return None
    return 1e3 * sum(e - s for _, s, e in acts) / 1e9 / len(run.batches)
