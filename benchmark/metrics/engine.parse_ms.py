"""Host milliseconds per batch of parse_query over the batch's texts (the
first part of engine.dispatch_ms), averaged over the window's batches."""

UNIT = "ms"
TRACE = True


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.t_parsed - b.t_take for b in run.batches) / len(run.batches)
