"""Tensor ops of the PyTorch port; maps to `acestep_tpu/ops`."""
