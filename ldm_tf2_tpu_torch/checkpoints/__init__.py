"""Weight loading, export and training checkpoints for the PyTorch port."""

from ldm_tf2_tpu_torch.checkpoints.blob import blob_exists, export_blob, read_blob
from ldm_tf2_tpu_torch.checkpoints.bridge import (
    load_params, params_from_jax, params_to_jax,
)
from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager

__all__ = ["CheckpointManager", "blob_exists", "export_blob", "load_params",
           "params_from_jax", "params_to_jax", "read_blob"]
