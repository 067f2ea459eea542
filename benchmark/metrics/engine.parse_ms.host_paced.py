"""engine.parse_ms in a cell whose rate and tail the host's speed sets
more widely than any bound holds (its end-to-end metrics are the peak and
the set-up)."""

UNIT = "ms"
TRACE = True


def read(run):
    from benchmark import run as harness

    return harness.reader("engine.parse_ms").read(run)
