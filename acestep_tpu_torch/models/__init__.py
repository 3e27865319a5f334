"""Models of the PyTorch port; maps to `acestep_tpu/models`."""
