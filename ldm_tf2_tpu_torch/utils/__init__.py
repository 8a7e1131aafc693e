"""Utilities of the PyTorch port."""

from ldm_tf2_tpu_torch.utils.logging import MetricLogger

__all__ = ["MetricLogger"]
