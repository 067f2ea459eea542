"""The window's 95th percentile latency, as the end-to-end p95_ms reads
it, in a cell whose tail the host's speed sets more widely than any bound
holds, read in the traced run (the profiler's cost included), with no
bound."""

UNIT = "ms"
TRACE = True


def read(run):
    from benchmark import run as harness

    return harness.reader("p95_ms").read(run)
