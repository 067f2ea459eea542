"""torch.cuda.max_memory_allocated() over the port's set-up and the
window (the peak is reset once the benchmark's own generator has freed
the card), in GiB."""

UNIT = "GiB"
TRACE = False


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
