"""Beta schedule and DDIM coefficient tables (numpy only).

A copy of ``ldm_tf2_tpu.diffusion.schedule``: float64 numpy on the host,
cast once to float32 tables.  The "scaled-linear" schedule is
``linspace(sqrt(b0), sqrt(b1), T)**2``, the CompVis latent-diffusion
default; the DDIM sub-sequence is "uniform" (the reference rule),
"trailing" or "karras".
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable container of schedule tables (all numpy float32 on host).

    Tables over the full ``num_steps`` training timeline:
      betas, alphas, alphas_cumprod, alphas_cumprod_prev,
      sqrt_alphas_cumprod, sqrt_one_minus_alphas_cumprod,
      log_one_minus_alphas_cumprod, sqrt_recip_alphas_cumprod,
      sqrt_recipm1_alphas_cumprod, posterior_variance,
      posterior_log_variance_clipped, posterior_mean_coef1/2
      (model_runners.py:379-404).

    Tables over the DDIM sub-sequence (length ``num_ddim_steps``):
      ddim_steps (int32 timestep ids), ddim_alphas_cumprod,
      ddim_alphas_cumprod_prev, ddim_sigmas,
      ddim_sqrt_recip_alphas_cumprod, ddim_sqrt_recipm1_alphas_cumprod
      (model_runners.py:406-423).

    Arrays are plain numpy; the sampler reads one entry per step on the
    host.
    """

    num_steps: int
    num_ddim_steps: int
    eta: float
    v_posterior: float
    timestep_spacing: str

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    ddim_steps: np.ndarray
    ddim_alphas_cumprod: np.ndarray
    ddim_alphas_cumprod_prev: np.ndarray
    ddim_sigmas: np.ndarray
    ddim_sqrt_recip_alphas_cumprod: np.ndarray
    ddim_sqrt_recipm1_alphas_cumprod: np.ndarray


def _karras_subsequence(
    alphas_cumprod: np.ndarray, num_ddim_steps: int, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. 2022 (EDM) sigma-space spacing, mapped onto the
    discrete timestep grid.

    sigma(t) = sqrt((1 - acp_t) / acp_t) is strictly increasing in t; the
    Karras ramp places the ``num_ddim_steps`` sample sigmas as
    ``(smax^(1/rho) + u (smin^(1/rho) - smax^(1/rho)))^rho`` for u in
    [0, 1], which concentrates steps at low noise where few-step ODE
    solvers accumulate most of their truncation error.  Each ramp sigma is
    mapped to a fractional timeline position by interpolating log-sigma
    and rounded to the nearest integer timestep; rounding collisions at
    the dense low-noise end are resolved by forcing strict monotonicity.
    Returns an ascending int32 array (same orientation as the reference's
    uniform sub-sequence, model_runners.py:406-409).

    The sigma ramp ends at ``sigmas[1]``, not ``sigmas[0]``, and steps are
    clamped to >= 1: a sub-sequence touching t=0 would make
    ``ddim_alphas_cumprod_prev[0] == ddim_alphas_cumprod[0]`` (the prev
    table prepends acp[0]), turning the final DDIM/DPM++ update into an
    exact identity — one wasted U-Net eval and no final denoise.  The +1
    floor mirrors the uniform rule's +1 shift (model_runners.py:406-409).
    """
    sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    ramp = np.linspace(0.0, 1.0, num_ddim_steps, dtype=np.float64)
    min_inv = sigmas[1] ** (1.0 / rho)
    max_inv = sigmas[-1] ** (1.0 / rho)
    karras = (max_inv + ramp * (min_inv - max_inv)) ** rho  # descending
    frac_t = np.interp(
        np.log(karras), np.log(sigmas), np.arange(len(sigmas), dtype=np.float64)
    )
    steps = np.round(frac_t).astype(np.int64)[::-1].copy()  # ascending
    steps = np.maximum(steps, 1)
    for i in range(1, len(steps)):  # dedupe upward
        if steps[i] <= steps[i - 1]:
            steps[i] = steps[i - 1] + 1
    steps = np.minimum(steps, len(sigmas) - 1)
    for i in range(len(steps) - 2, -1, -1):  # re-dedupe from the top
        if steps[i] >= steps[i + 1]:
            steps[i] = steps[i + 1] - 1
    if steps[0] < 1:
        raise ValueError(
            f"karras spacing cannot place {num_ddim_steps} distinct steps "
            f"on a {len(sigmas)}-step timeline without touching t=0"
        )
    return steps.astype(np.int32)


def make_schedule(
    num_steps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    v_posterior: float = 0.0,
    eta: float = 0.0,
    num_ddim_steps: int = 50,
    timestep_spacing: str = "uniform",
) -> DiffusionSchedule:
    """Build all schedule tables (defaults mirror model_runners.py:354-365).

    The production config uses beta_start=0.00085, beta_end=0.012
    (all_in_one_config.yaml:104-111 in the reference).

    ``timestep_spacing`` selects the DDIM sub-sequence (additive beyond the
    reference, which only has the uniform ``range(0, T, T//S) + 1`` rule):
      * ``"uniform"`` — the reference's leading-uniform spacing (exact).
      * ``"trailing"`` — uniform from the FINAL timestep downward
        (``round(arange(T, 0, -T/S)) - 1``); starts sampling at t=T-1
        instead of t≈T-20, which few-step deterministic samplers prefer.
      * ``"karras"`` — Karras/EDM rho=7 sigma spacing (see
        ``_karras_subsequence``), the standard choice for DPM-Solver++ at
        low step counts.
    Downstream samplers and solvers only consume the per-index ddim_*
    tables, so every spacing works with every sampler unchanged.
    """
    # "scaled-linear": linspace in sqrt-beta space, then squared
    # (model_runners.py:379-382), float64 throughout.
    betas = (
        np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float64)
        ** 2
    )
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = (
        (1.0 - v_posterior)
        * betas
        * (1.0 - alphas_cumprod_prev)
        / (1.0 - alphas_cumprod)
        + v_posterior * betas
    )

    if timestep_spacing == "uniform":
        # DDIM sub-sequence: range(0, T, T//S), shifted by +1 when
        # subsampling (model_runners.py:406-409).  For T=1000, S=50:
        # [1, 21, ..., 981].
        ddim_steps = np.arange(
            0, num_steps, num_steps // num_ddim_steps, dtype=np.int32
        )
        if num_ddim_steps < num_steps:
            ddim_steps = ddim_steps + 1
    elif timestep_spacing == "trailing":
        ddim_steps = (
            np.round(np.arange(num_steps, 0, -num_steps / num_ddim_steps))
            .astype(np.int32)[::-1]
            - 1
        )
    elif timestep_spacing == "karras":
        ddim_steps = _karras_subsequence(alphas_cumprod, num_ddim_steps)
    else:
        raise ValueError(
            "timestep_spacing must be uniform|trailing|karras, got "
            f"{timestep_spacing!r}"
        )

    ddim_alphas_cumprod = alphas_cumprod[ddim_steps]
    ddim_alphas_cumprod_prev = np.concatenate(
        [[alphas_cumprod[0]], alphas_cumprod[ddim_steps[:-1]]]
    )
    # sigma_t = eta * sqrt((1-acp_prev)/(1-acp) * (1-acp/acp_prev))
    # (model_runners.py:416-419).
    ddim_sigmas = eta * np.sqrt(
        (1.0 - ddim_alphas_cumprod_prev)
        / (1.0 - ddim_alphas_cumprod)
        * (1.0 - ddim_alphas_cumprod / ddim_alphas_cumprod_prev)
    )

    sqrt_recip_alphas_cumprod = np.sqrt(1.0 / alphas_cumprod)
    sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / alphas_cumprod - 1.0)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionSchedule(
        num_steps=num_steps,
        num_ddim_steps=num_ddim_steps,
        eta=eta,
        v_posterior=v_posterior,
        timestep_spacing=timestep_spacing,
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(sqrt_recip_alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=f32(sqrt_recipm1_alphas_cumprod),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))
        ),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev)
            * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)
        ),
        ddim_steps=ddim_steps.astype(np.int32),
        ddim_alphas_cumprod=f32(ddim_alphas_cumprod),
        ddim_alphas_cumprod_prev=f32(ddim_alphas_cumprod_prev),
        ddim_sigmas=f32(ddim_sigmas),
        ddim_sqrt_recip_alphas_cumprod=f32(sqrt_recip_alphas_cumprod[ddim_steps]),
        ddim_sqrt_recipm1_alphas_cumprod=f32(
            sqrt_recipm1_alphas_cumprod[ddim_steps]
        ),
    )
