"""Queries whose top-k rows reached the host in the window, per second of
the window (from the window's start to the last batch's fetch)."""

UNIT = "queries/s"
TRACE = False


def read(run):
    if run.window_s <= 0:
        return None
    return sum(b.n for b in run.batches) / run.window_s
