"""Host seconds of DeviceIndex.from_snapshot over the shard's snapshot
(layouts, forward arrays, position planes, hot cache, upload), to the
card's synchronize."""

UNIT = "s"
TRACE = True


def read(run):
    return run.index_build_s
