"""95th percentile of every answered query's latency: from when its batch's
texts were taken from the stream (before parse_query) until finish()
returned the batch's rows."""

import numpy as np

UNIT = "ms"
TRACE = False


def read(run):
    lat = np.concatenate([np.full(b.n, b.t_done - b.t_take) for b in run.batches])
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
