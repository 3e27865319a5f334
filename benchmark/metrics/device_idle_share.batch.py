"""`device_idle_share.batch`: see `harness.readers.device_idle_share` (the batch cells)."""

from harness import readers


def read(run):
    return readers.device_idle_share(run)
