"""`mfu.batch`: see `harness.readers.mfu` (the batch cells)."""

from harness import readers


def read(run):
    return readers.mfu(run)
