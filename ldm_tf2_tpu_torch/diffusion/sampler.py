"""DDIM reverse-process sampling with classifier-free guidance.

Counterpart of ``ldm_tf2_tpu.diffusion.sampler`` (``apply_cfg``,
``ddim_step``, ``ddim_update``, ``ddim_sample_loop``).  The JAX package's
``lax.scan`` becomes a Python loop, and its PRNG key an explicit
``torch.Generator``.  CFG runs one U-Net call on the doubled [2B] batch,
unconditional half first; the split comes from the batch, not a fixed size.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule

# An epsilon model: (xt_doubled [2B,H,W,C], t [2B], context [2B,S,D]) -> eps.
EpsModel = Callable[..., torch.Tensor]


def apply_cfg(eps2, guidance_scale, guidance_rescale: float = 0.0):
    """``eps_u + s * (eps_c - eps_u)`` over a doubled batch (uncond first),
    with optional guidance rescale phi (Lin et al. 2023, §3.4):
    ``phi * eps_cfg * std(eps_c)/std(eps_cfg) + (1-phi) * eps_cfg``."""
    eps_uncond, eps_cond = torch.chunk(eps2, 2, dim=0)
    eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
    if guidance_rescale == 0.0:
        return eps
    dims = tuple(range(1, eps.dim()))
    std_cond = eps_cond.std(dim=dims, keepdim=True, correction=0)
    std_cfg = torch.clamp(eps.std(dim=dims, keepdim=True, correction=0),
                          min=1e-6)
    phi = guidance_rescale
    return phi * (eps * (std_cond / std_cfg)) + (1.0 - phi) * eps


def ddim_update(schedule: DiffusionSchedule, xt, eps, index: int,
                generator: torch.Generator | None = None,
                clip_denoised: bool = False, noise=None):
    """The post-epsilon DDIM update: pred_x0 from the recip-alpha tables,
    the DDIM mean, and the eta noise.  Returns (sample, pred_x0)."""
    f32 = lambda tbl: np.float32(tbl[index])
    pred_x0 = (
        float(f32(schedule.ddim_sqrt_recip_alphas_cumprod)) * xt
        - float(f32(schedule.ddim_sqrt_recipm1_alphas_cumprod)) * eps
    )
    if clip_denoised:
        pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    acp_prev = f32(schedule.ddim_alphas_cumprod_prev)
    sigma = f32(schedule.ddim_sigmas)
    dir_coef = np.sqrt(np.float32(1.0) - acp_prev - sigma * sigma)
    mean = float(np.sqrt(acp_prev)) * pred_x0 + float(dir_coef) * eps
    if noise is None:
        if sigma == 0.0:
            return mean, pred_x0
        noise = torch.randn(xt.shape, generator=generator, device=xt.device,
                            dtype=xt.dtype)
    return mean + float(sigma) * noise.to(xt.dtype), pred_x0


def ddim_step(eps_model: EpsModel, schedule: DiffusionSchedule, xt, cond,
              index: int, generator: torch.Generator | None = None,
              guidance_scale: float = 1.0, clip_denoised: bool = False,
              guidance_rescale: float = 0.0, noise=None):
    """One DDIM reverse step with CFG; ``cond`` is [2B, seq, d], uncond
    half first.  Returns (sample, pred_x0)."""
    t = torch.full((xt.shape[0] * 2,), float(schedule.ddim_steps[index]),
                   dtype=torch.float32, device=xt.device)
    eps = apply_cfg(eps_model(torch.cat([xt, xt], dim=0), t, cond),
                    guidance_scale, guidance_rescale)
    return ddim_update(schedule, xt, eps.to(xt.dtype), index, generator,
                       clip_denoised, noise)


def ddim_sample_loop(eps_model: EpsModel, schedule: DiffusionSchedule,
                     context, shape, generator: torch.Generator | None = None,
                     guidance_scale: float = 5.0, clip_denoised: bool = False,
                     init_noise=None, guidance_rescale: float = 0.0,
                     step_noises=None, return_trajectory: bool = False):
    """The full S-step DDIM reverse process.

    context: [2B, seq, d], uncond half first; shape: latent [B, h, w, c].
    init_noise: injected initial latent (else drawn from ``generator``).
    step_noises: [S, B, h, w, c] injected per-step sigma-noise in loop
    order (index S-1 .. 0); None draws from ``generator`` when eta > 0.
    Returns x0 [B, h, w, c]; with return_trajectory, (x0, [S, B, h, w, c]).
    """
    if init_noise is None:
        xt = torch.randn(tuple(shape), generator=generator,
                         device=context.device, dtype=context.dtype)
    else:
        xt = init_noise.to(device=context.device, dtype=context.dtype)
    traj = []
    num_steps = len(schedule.ddim_steps)
    for n, index in enumerate(range(num_steps - 1, -1, -1)):
        noise = None if step_noises is None else step_noises[n].to(xt.device)
        xt, _ = ddim_step(eps_model, schedule, xt, context, index, generator,
                          guidance_scale, clip_denoised, guidance_rescale,
                          noise)
        if return_trajectory:
            traj.append(xt)
    if return_trajectory:
        return xt, torch.stack(traj)
    return xt
