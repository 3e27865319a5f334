"""`attn_roofline.batch`: see `harness.readers.attn_roofline` (the batch cells)."""

from harness import readers


def read(run):
    return readers.attn_roofline(run)
