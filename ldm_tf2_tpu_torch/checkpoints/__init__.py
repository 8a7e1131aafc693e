"""Weight loading for the PyTorch port."""

from ldm_tf2_tpu_torch.checkpoints.bridge import (
    load_params, params_from_jax, read_blob,
)

__all__ = ["load_params", "params_from_jax", "read_blob"]
