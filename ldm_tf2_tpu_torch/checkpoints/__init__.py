"""Weight loading and training checkpoints for the PyTorch port."""

from ldm_tf2_tpu_torch.checkpoints.bridge import (
    load_params, params_from_jax, read_blob,
)
from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager

__all__ = ["CheckpointManager", "load_params", "params_from_jax", "read_blob"]
