"""`dit_share.batch`: see `harness.readers.dit_share` (the batch cells)."""

from harness import readers


def read(run):
    return readers.dit_share(run)
