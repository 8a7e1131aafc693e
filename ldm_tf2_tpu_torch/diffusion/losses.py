"""Loss functions of the trainers (counterpart of
``ldm_tf2_tpu.diffusion.losses``).  ``q_sample`` serves the LDM trainer;
the discriminator losses and ``nll_loss`` wait for the autoencoder
trainer."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real, logits_fake):
    """0.5 * (mean relu(1 - real) + mean relu(1 + fake))."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    """0.5 * (mean softplus(-real) + mean softplus(fake))."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


D_LOSS_MAP = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss}


def q_sample(sqrt_alphas_cumprod, sqrt_one_minus_alphas_cumprod, x0, t, eps):
    """Forward-process sample q(x_t | x_0): the coefficients gathered at the
    per-example timesteps ``t``, cast to x0's dtype and broadcast over
    [B, 1, 1, 1]."""
    c0 = sqrt_alphas_cumprod[t].to(x0.dtype)[:, None, None, None]
    c1 = sqrt_one_minus_alphas_cumprod[t].to(x0.dtype)[:, None, None, None]
    return c0 * x0 + c1 * eps


def nll_loss(inputs, outputs, lpips_value, lpips_weight: float = 1.0,
             reduce_loss: bool = False):
    """|x - x_hat| + w * LPIPS, reduced as sum / B or as the mean."""
    loss = (inputs - outputs).abs() + lpips_weight * lpips_value
    if reduce_loss:
        return loss.sum() / loss.shape[0]
    return loss.mean()
