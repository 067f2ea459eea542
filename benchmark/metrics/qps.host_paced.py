"""The window's rate, as the end-to-end qps reads it, in a cell whose rate
the host's speed sets more widely than any bound holds (the host paces
the card there), read in the traced run (the profiler's cost included),
with no bound."""

UNIT = "queries/s"
TRACE = True


def read(run):
    from benchmark import run as harness

    return harness.reader("qps").read(run)
