"""Data parallelism of the port over ``torch.distributed`` (``mesh``) and
the draws a rank shares with the global batch (``rng``)."""

from ldm_tf2_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, all_reduce_sum, barrier, check_data_parallel,
    create_mesh, gather_rows, global_mean, maybe_initialize_distributed,
    replicate, shard_batch,
)
from ldm_tf2_tpu_torch.parallel.rng import RowSlice

__all__ = ["Mesh", "RowSlice", "all_reduce_mean_", "all_reduce_sum", "barrier",
           "check_data_parallel", "create_mesh", "gather_rows", "global_mean",
           "maybe_initialize_distributed", "replicate", "shard_batch"]
