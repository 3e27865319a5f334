"""Utility modules of the PyTorch port (copies, not imports, of `acestep_tpu/utils`)."""
