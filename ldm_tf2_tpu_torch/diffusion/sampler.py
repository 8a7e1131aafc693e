"""DDIM and DDPM reverse-process sampling with classifier-free guidance.

Counterpart of ``ldm_tf2_tpu.diffusion.sampler`` (``apply_cfg``,
``ddim_step``, ``ddim_update``, ``ddim_sample_loop``,
``ddim_sample_loop_deepcache``, ``ddim_img2img_loop``,
``ddim_sample_loop_progressive``, ``ddpm_step``, ``ddpm_sample_loop``).
The JAX package's ``lax.scan`` becomes a Python loop, and its PRNG key an
explicit ``torch.Generator``; every loop also takes the noise it would draw
(``init_noise``, ``step_noises``), so a test can hand it the JAX package's
draws.  CFG runs one U-Net call on the doubled [2B] batch, unconditional
half first; the split comes from the batch, not a fixed size.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ldm_tf2_tpu_torch.diffusion.losses import q_sample
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule

# An epsilon model: (xt_doubled [2B,H,W,C], t [2B], context [2B,S,D]) -> eps.
EpsModel = Callable[..., torch.Tensor]


def apply_cfg(eps2, guidance_scale, guidance_rescale: float = 0.0):
    """``eps_u + s * (eps_c - eps_u)`` over a doubled batch (uncond first),
    with optional guidance rescale phi (Lin et al. 2023, §3.4):
    ``phi * eps_cfg * std(eps_c)/std(eps_cfg) + (1-phi) * eps_cfg``.

    ``guidance_scale`` is a number or a per-slot [B, 1, 1, 1] tensor (the
    server's micro-batches); either is cast to eps's dtype first, as the
    JAX package does, so a float32 scale never upcasts bf16 eps."""
    eps_uncond, eps_cond = torch.chunk(eps2, 2, dim=0)
    if torch.is_tensor(guidance_scale):
        scale = guidance_scale.to(device=eps_cond.device, dtype=eps_cond.dtype)
    else:  # rounded on the host: a device scalar would cost a copy a step
        scale = torch.tensor(float(guidance_scale), dtype=eps_cond.dtype).item()
    eps = eps_uncond + scale * (eps_cond - eps_uncond)
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


def _initial(context, shape, generator, init_noise):
    """The initial latent: ``init_noise``, else a draw from ``generator``."""
    if init_noise is None:
        return torch.randn(tuple(shape), generator=generator, device=context.device,
                           dtype=context.dtype)
    return init_noise.to(device=context.device, dtype=context.dtype)


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
    xt = _initial(context, shape, generator, init_noise)
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


def deepcache_model(eps_model_full, eps_model_shallow, cache_interval: int) -> EpsModel:
    """DeepCache's steps as one eps model for a loop that calls its model
    once a step, in loop order: the full U-Net (which also returns the
    deep boundary feature) at every ``cache_interval``-th call, counting
    from the first, and the shallow levels against the last full call's
    feature in between.  That is the JAX package's groups: one full step at
    each group's base index and ``interval - 1`` shallow steps, the tail
    group (``S % interval`` steps) based at ``tail - 1``.

    eps_model_full: (xt2 [2B], t [2B], context) -> (eps [2B], cache);
    eps_model_shallow: (xt2, t, context, cache) -> eps."""
    interval = max(int(cache_interval), 1)
    step, cache = 0, None

    def eps_model(x, t, context):
        nonlocal step, cache
        if step % interval == 0:
            eps, cache = eps_model_full(x, t, context)
        else:
            eps = eps_model_shallow(x, t, context, cache)
        step += 1
        return eps

    return eps_model


def ddim_sample_loop_deepcache(eps_model_full, eps_model_shallow,
                               schedule: DiffusionSchedule, context, shape,
                               generator: torch.Generator | None = None,
                               guidance_scale: float = 5.0, cache_interval: int = 2,
                               clip_denoised: bool = False, init_noise=None,
                               guidance_rescale: float = 0.0, step_noises=None):
    """The DDIM loop with deep-feature caching (DeepCache, Ma et al. 2023):
    ``ddim_sample_loop``'s steps and draws, the U-Net calls scheduled by
    ``deepcache_model``.  ``cache_interval=1`` runs the full U-Net at every
    step and is ``ddim_sample_loop`` itself.  step_noises: [S, B, h, w, c]
    in loop order, as for ``ddim_sample_loop``.  Returns x0 [B, h, w, c]."""
    return ddim_sample_loop(
        deepcache_model(eps_model_full, eps_model_shallow, cache_interval),
        schedule, context, shape, generator, guidance_scale, clip_denoised,
        init_noise, guidance_rescale, step_noises)


def ddim_img2img_loop(eps_model: EpsModel, schedule: DiffusionSchedule, context,
                      init_latent, generator: torch.Generator | None = None,
                      strength: float = 0.75, guidance_scale: float = 5.0,
                      clip_denoised: bool = False, mask=None, init_noise=None,
                      guidance_rescale: float = 0.0, step_noises=None,
                      keep_noises=None):
    """SDEdit-style image-to-image and latent inpainting.

    Diffuses ``init_latent`` ([B, h, w, c], already times the scale factor)
    forward to DDIM step ``t_enc = round(strength * S)`` (Python's round,
    half to even) with ``q_sample`` on the full-timeline tables, then runs
    the DDIM steps ``t_enc - 1 .. 0``; ``t_enc == 0`` returns
    ``init_latent`` with no model call.  With ``mask`` (broadcastable to
    the latent, 1 = regenerate, 0 = keep) the kept region is re-imposed
    after every step at that step's noise level, from fresh forward noise,
    and replaced by ``init_latent`` itself at the end.

    Test hooks: ``init_noise`` (the forward noise), ``step_noises`` ([t_enc,
    B, h, w, c], the eta noise in loop order) and ``keep_noises`` (the
    same layout, the blend's draws); else each is drawn from
    ``generator``.  Returns x0 [B, h, w, c]."""
    num_steps = len(schedule.ddim_steps)
    if not 0.0 <= strength <= 1.0:
        raise ValueError(f"strength must be in [0, 1], got {strength}")
    t_enc = int(round(float(strength) * num_steps))
    if t_enc == 0:
        return init_latent
    device, dtype = init_latent.device, init_latent.dtype
    if init_noise is None:
        noise0 = torch.randn(init_latent.shape, generator=generator, device=device,
                             dtype=dtype)
    else:
        noise0 = init_noise.to(device=device, dtype=dtype)
    table = lambda a: torch.as_tensor(a, device=device)
    t_start = torch.full((init_latent.shape[0],), int(schedule.ddim_steps[t_enc - 1]),
                         dtype=torch.long, device=device)
    xt = q_sample(table(schedule.sqrt_alphas_cumprod),
                  table(schedule.sqrt_one_minus_alphas_cumprod), init_latent,
                  t_start, noise0)
    if mask is not None:  # in the sample's dtype: never upcasts a bf16 sample
        mask = mask.to(device=device, dtype=dtype)
    for n, index in enumerate(range(t_enc - 1, -1, -1)):
        noise = None if step_noises is None else step_noises[n].to(device)
        xt, _ = ddim_step(eps_model, schedule, xt, context, index, generator,
                          guidance_scale, clip_denoised, guidance_rescale, noise)
        if mask is None:
            continue
        # the coefficients in the sample's dtype before the sqrt, as the
        # JAX package casts acp_prev first
        acp_prev = torch.tensor(float(schedule.ddim_alphas_cumprod_prev[index]),
                                dtype=dtype)
        c0 = torch.sqrt(acp_prev).item()
        c1 = torch.sqrt(torch.clamp(1.0 - acp_prev, min=0.0)).item()
        if keep_noises is None:
            keep_noise = torch.randn(xt.shape, generator=generator, device=device,
                                     dtype=dtype)
        else:
            keep_noise = keep_noises[n].to(device=device, dtype=dtype)
        xt = mask * xt + (1.0 - mask) * (c0 * init_latent + c1 * keep_noise)
    if mask is not None:  # the kept region is the init latent itself
        xt = mask * xt + (1.0 - mask) * init_latent
    return xt


def ddim_sample_loop_progressive(eps_model: EpsModel, schedule: DiffusionSchedule,
                                 context, shape,
                                 generator: torch.Generator | None = None,
                                 guidance_scale: float = 5.0, record_freq: int = 5,
                                 clip_denoised: bool = False,
                                 guidance_rescale: float = 0.0, init_noise=None,
                                 step_noises=None):
    """The DDIM loop that also records the sample and pred_x0 of every
    ``record_freq``-th step: record r holds DDIM index r * record_freq, for
    r < num_steps // record_freq (the JAX package's one-hot insert keeps
    the last write of each slot, which is that index).

    Returns (x0, sample_progress, pred_x0_progress), the progress tensors
    [B, num_records, h, w, c] in latent space (the caller decodes)."""
    num_steps = len(schedule.ddim_steps)
    num_records = num_steps // record_freq
    xt = _initial(context, shape, generator, init_noise)
    samples = [None] * num_records
    pred_x0s = [None] * num_records
    for n, index in enumerate(range(num_steps - 1, -1, -1)):
        noise = None if step_noises is None else step_noises[n].to(xt.device)
        xt, pred_x0 = ddim_step(eps_model, schedule, xt, context, index, generator,
                                guidance_scale, clip_denoised, guidance_rescale, noise)
        if index % record_freq == 0 and index // record_freq < num_records:
            samples[index // record_freq] = xt
            pred_x0s[index // record_freq] = pred_x0
    empty = torch.zeros((shape[0], 0, *shape[1:]), dtype=xt.dtype, device=xt.device)
    stack = lambda xs: torch.stack(xs, dim=1) if xs else empty
    return xt, stack(samples), stack(pred_x0s)


def ddpm_step(eps_model: EpsModel, schedule: DiffusionSchedule, xt, cond, t: int,
              generator: torch.Generator | None = None, guidance_scale: float = 1.0,
              clip_denoised: bool = True, guidance_rescale: float = 0.0, noise=None):
    """One ancestral (DDPM) reverse step at timestep ``t`` of the full
    timeline, from the posterior tables.  ``noise``: the standard normal
    draw (else drawn from ``generator``).  Returns (sample, pred_x0)."""
    t_vec = torch.full((xt.shape[0] * 2,), float(t), dtype=torch.float32,
                       device=xt.device)
    eps = apply_cfg(eps_model(torch.cat([xt, xt], dim=0), t_vec, cond),
                    guidance_scale, guidance_rescale).to(xt.dtype)
    f32 = lambda tbl: np.float32(tbl[t])
    pred_x0 = (float(f32(schedule.sqrt_recip_alphas_cumprod)) * xt
               - float(f32(schedule.sqrt_recipm1_alphas_cumprod)) * eps)
    if clip_denoised:
        pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    mean = (float(f32(schedule.posterior_mean_coef1)) * pred_x0
            + float(f32(schedule.posterior_mean_coef2)) * xt)
    if t == 0:
        return mean, pred_x0
    if noise is None:
        noise = torch.randn(xt.shape, generator=generator, device=xt.device,
                            dtype=xt.dtype)
    std = np.exp(np.float32(0.5) * f32(schedule.posterior_log_variance_clipped))
    return mean + float(std) * noise.to(xt.dtype), pred_x0


def ddpm_sample_loop(eps_model: EpsModel, schedule: DiffusionSchedule, context, shape,
                     generator: torch.Generator | None = None,
                     guidance_scale: float = 5.0, clip_denoised: bool = True,
                     guidance_rescale: float = 0.0, init_noise=None, step_noises=None):
    """Ancestral sampling over the whole ``schedule.num_steps`` timeline.
    step_noises: [T, B, h, w, c] draws in loop order (t = T-1 .. 0); None
    draws from ``generator``.  Returns x0 [B, h, w, c]."""
    xt = _initial(context, shape, generator, init_noise)
    for n, t in enumerate(range(schedule.num_steps - 1, -1, -1)):
        noise = None if step_noises is None else step_noises[n].to(xt.device)
        xt, _ = ddpm_step(eps_model, schedule, xt, context, t, generator,
                          guidance_scale, clip_denoised, guidance_rescale, noise)
    return xt
