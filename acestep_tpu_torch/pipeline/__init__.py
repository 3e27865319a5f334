"""Generation pipeline of the PyTorch port; maps to `acestep_tpu/pipeline`."""
