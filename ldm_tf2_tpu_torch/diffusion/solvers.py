"""Multistep ODE solvers for the reverse process: PLMS and DPM-Solver++(2M).

Counterpart of ``ldm_tf2_tpu.diffusion.solvers`` (``plms_sample_loop``,
``dpm_solver_pp_2m_sample_loop``,
``dpm_solver_pp_2m_sample_loop_deepcache``).  All are deterministic, one
U-Net call per step over the DDIM timestep sub-sequence, with
classifier-free guidance on the doubled [2B] batch as in
``sampler.ddim_step``.  The JAX package's
``lax.scan`` carry becomes Python state; its schedule arithmetic, done in
float32 on the device there, is done in float32 numpy on the host here and
applied as Python numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ldm_tf2_tpu_torch.diffusion.sampler import (
    EpsModel, _initial, apply_cfg, deepcache_model,
)
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule


def _cfg_eps(eps_model, schedule, xt, cond, index, guidance_scale,
             guidance_rescale=0.0):
    """One CFG-guided eps prediction at DDIM index ``index``."""
    t = torch.full((xt.shape[0] * 2,), float(schedule.ddim_steps[index]),
                   dtype=torch.float32, device=xt.device)
    eps = apply_cfg(eps_model(torch.cat([xt, xt], dim=0), t, cond),
                    guidance_scale, guidance_rescale)
    return eps.to(xt.dtype)


def _ddim_update(schedule, xt, eps, index, clip_denoised):
    """The deterministic (eta = 0) DDIM transition with a given eps."""
    f32 = lambda tbl: np.float32(tbl[index])
    pred_x0 = (float(f32(schedule.ddim_sqrt_recip_alphas_cumprod)) * xt
               - float(f32(schedule.ddim_sqrt_recipm1_alphas_cumprod)) * eps)
    if clip_denoised:
        pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    acp_prev = f32(schedule.ddim_alphas_cumprod_prev)
    return (float(np.sqrt(acp_prev)) * pred_x0
            + float(np.sqrt(np.float32(1.0) - acp_prev)) * eps)


def plms_sample_loop(eps_model: EpsModel, schedule: DiffusionSchedule, context, shape,
                     generator: torch.Generator | None = None,
                     guidance_scale: float = 5.0, clip_denoised: bool = False,
                     init_noise=None, guidance_rescale: float = 0.0):
    """PLMS / PNDM sampling: one model call per step, an eps history of 3.
    The order ramps 1 -> 4 (Adams-Bashforth) as the history fills; then
    ``eps' = (55 e - 59 e1 + 37 e2 - 9 e3) / 24``, followed by the
    deterministic DDIM update with eps'.  Returns x0 [B, h, w, c]."""
    xt = _initial(context, shape, generator, init_noise)
    history = []  # e1, e2, e3: the previous steps' eps, newest first
    for index in range(len(schedule.ddim_steps) - 1, -1, -1):
        e = _cfg_eps(eps_model, schedule, xt, context, index, guidance_scale,
                     guidance_rescale)
        if len(history) == 0:
            e_prime = e
        elif len(history) == 1:
            e_prime = (3.0 * e - history[0]) / 2.0
        elif len(history) == 2:
            e_prime = (23.0 * e - 16.0 * history[0] + 5.0 * history[1]) / 12.0
        else:
            e_prime = (55.0 * e - 59.0 * history[0] + 37.0 * history[1]
                       - 9.0 * history[2]) / 24.0
        xt = _ddim_update(schedule, xt, e_prime, index, clip_denoised)
        history = [e] + history[:2]
    return xt


def dpm_solver_pp_2m_sample_loop(eps_model: EpsModel, schedule: DiffusionSchedule,
                                 context, shape,
                                 generator: torch.Generator | None = None,
                                 guidance_scale: float = 5.0,
                                 clip_denoised: bool = False, init_noise=None,
                                 guidance_rescale: float = 0.0):
    """DPM-Solver++(2M), second-order multistep in data-prediction form.

    With lambda = log(alpha / sigma) (alpha = sqrt(acp), sigma =
    sqrt(1 - acp)), each step from a DDIM index to its "prev" entry is
      x <- (sigma_prev / sigma) x - alpha_prev (exp(-h) - 1) D,
      h = lambda_prev - lambda,
      D = (1 + 1/(2r)) x0 - 1/(2r) x0_last,  r = h_last / h
    (first step: D = x0).  Returns x0 [B, h, w, c]."""
    xt = _initial(context, shape, generator, init_noise)
    one = np.float32(1.0)
    acp = np.asarray(schedule.ddim_alphas_cumprod, np.float32)
    acp_prev = np.asarray(schedule.ddim_alphas_cumprod_prev, np.float32)
    alpha, sigma = np.sqrt(acp), np.sqrt(one - acp)
    alpha_p, sigma_p = np.sqrt(acp_prev), np.sqrt(one - acp_prev)
    lam, lam_p = np.log(alpha / sigma), np.log(alpha_p / sigma_p)
    x0_last, h_last = None, one
    for index in range(len(schedule.ddim_steps) - 1, -1, -1):
        e = _cfg_eps(eps_model, schedule, xt, context, index, guidance_scale,
                     guidance_rescale)
        x0 = (xt - float(sigma[index]) * e) / float(alpha[index])
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        h = lam_p[index] - lam[index]
        if x0_last is None:
            d = x0
        else:
            coef = one / (np.float32(2.0) * (h_last / h))
            d = float(one + coef) * x0 - float(coef) * x0_last
        xt = (float(sigma_p[index] / sigma[index]) * xt
              - float(alpha_p[index] * np.expm1(-h)) * d)
        x0_last, h_last = x0, h
    return xt


def dpm_solver_pp_2m_sample_loop_deepcache(eps_model_full, eps_model_shallow,
                                           schedule: DiffusionSchedule, context,
                                           shape,
                                           generator: torch.Generator | None = None,
                                           guidance_scale: float = 5.0,
                                           cache_interval: int = 2,
                                           clip_denoised: bool = False,
                                           init_noise=None,
                                           guidance_rescale: float = 0.0):
    """DPM-Solver++(2M) with DeepCache: ``dpm_solver_pp_2m_sample_loop``'s
    transition, its (x0_last, h_last) history running through full and
    shallow steps alike, the U-Net calls scheduled by
    ``sampler.deepcache_model``.  No per-step noise is drawn;
    ``cache_interval=1`` is the plain loop.  Returns x0 [B, h, w, c]."""
    return dpm_solver_pp_2m_sample_loop(
        deepcache_model(eps_model_full, eps_model_shallow, cache_interval),
        schedule, context, shape, generator, guidance_scale, clip_denoised,
        init_noise, guidance_rescale)
