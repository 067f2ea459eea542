"""Bytes of every tensor the port's DeviceIndex holds on the card
(DeviceIndex.device_bytes()), in GiB."""

UNIT = "GiB"
TRACE = True


def read(run):
    return run.index_bytes / 2**30
