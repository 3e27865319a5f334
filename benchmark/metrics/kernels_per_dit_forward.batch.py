"""`kernels_per_dit_forward.batch`: see `harness.readers.kernels_per_dit_forward` (the batch cells)."""

from harness import readers


def read(run):
    return readers.kernels_per_dit_forward(run)
