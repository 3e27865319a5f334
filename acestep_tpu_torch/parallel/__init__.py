"""Multi-process parallelism of the PyTorch port; maps to `acestep_tpu/parallel`."""

from acestep_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    make_mesh,
    rank_device,
    refuse_sp_tp,
    shard_batch,
    shard_params_dp,
)

__all__ = ["Mesh", "launch", "make_mesh", "rank_device", "refuse_sp_tp", "shard_batch", "shard_params_dp"]
