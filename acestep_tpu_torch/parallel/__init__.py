"""Multi-process parallelism of the PyTorch port; maps to `acestep_tpu/parallel`."""

from acestep_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    make_mesh,
    rank_device,
    shard_batch,
    shard_params_dp,
    shard_params_tp,
)
from acestep_tpu_torch.parallel.tensor import Shards

__all__ = ["Mesh", "Shards", "launch", "make_mesh", "rank_device", "shard_batch", "shard_params_dp",
           "shard_params_tp"]
