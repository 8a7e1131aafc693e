"""Config loading for the PyTorch port."""

from ldm_tf2_tpu_torch.configs.loader import compute_dtype, load_config, validate

__all__ = ["compute_dtype", "load_config", "validate"]
