"""Seconds from the process's start to the window's: imports, the shard
and stream drawn from the seed, the port's DeviceIndex and engine, the
warm-up batches (and, in a checkout's first run, the kernels' build)."""

UNIT = "s"
TRACE = False


def read(run):
    return run.setup_s
