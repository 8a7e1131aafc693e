"""Schedules, the DDIM and DDPM samplers and the multistep solvers of the
PyTorch port."""

from ldm_tf2_tpu_torch.diffusion.sampler import (
    apply_cfg, ddim_img2img_loop, ddim_sample_loop, ddim_sample_loop_deepcache,
    ddim_sample_loop_progressive, ddim_step, ddim_update, ddpm_sample_loop,
    ddpm_step,
)
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from ldm_tf2_tpu_torch.diffusion.solvers import (
    dpm_solver_pp_2m_sample_loop, dpm_solver_pp_2m_sample_loop_deepcache,
    plms_sample_loop,
)

__all__ = [
    "DiffusionSchedule", "apply_cfg", "ddim_img2img_loop", "ddim_sample_loop",
    "ddim_sample_loop_deepcache", "ddim_sample_loop_progressive", "ddim_step",
    "ddim_update", "ddpm_sample_loop", "ddpm_step",
    "dpm_solver_pp_2m_sample_loop", "dpm_solver_pp_2m_sample_loop_deepcache",
    "make_schedule", "plms_sample_loop",
]
