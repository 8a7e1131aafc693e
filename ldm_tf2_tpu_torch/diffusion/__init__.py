"""Schedules and the DDIM sampler of the PyTorch port."""

from ldm_tf2_tpu_torch.diffusion.sampler import (
    apply_cfg, ddim_sample_loop, ddim_step, ddim_update,
)
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule

__all__ = [
    "DiffusionSchedule", "apply_cfg", "ddim_sample_loop", "ddim_step",
    "ddim_update", "make_schedule",
]
