"""Host milliseconds per batch of the engine's dispatch: parse_query of
the batch's texts plus QueryEngine.rank_async (bucket, pack, upload,
launch), by the host clock around both, averaged over the window's
batches."""

UNIT = "ms"
TRACE = True


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.t_dispatched - b.t_take for b in run.batches) / len(run.batches)
