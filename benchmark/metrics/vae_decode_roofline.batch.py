"""`vae_decode_roofline.batch`: see `harness.readers.vae_decode_roofline` (the batch cells)."""

from harness import readers


def read(run):
    return readers.vae_decode_roofline(run)
