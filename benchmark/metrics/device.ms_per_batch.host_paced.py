"""device.ms_per_batch in a cell whose rate and tail the host's speed sets
more widely than any bound holds (its end-to-end metrics are the peak and
the set-up)."""

UNIT = "ms"
TRACE = True


def read(run):
    from benchmark import run as harness

    return harness.reader("device.ms_per_batch").read(run)
