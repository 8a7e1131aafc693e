"""GroupNorm over channels-last tensors, plain PyTorch.

Counterpart of ``ldm_tf2_tpu.ops.group_norm.group_norm`` with the
semantics of its default path, ``_mxu_stats_group_norm``: per-group sums
of x and x^2 in float32, variance E[x^2]-E[x]^2 clamped at 0, normalize,
affine and optional SiLU in float32, result in the input dtype.
"""

from __future__ import annotations

import torch


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
               activate: bool = False):
    """GroupNorm over [B, spatial..., C] with optional fused SiLU."""
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    b = x.shape[0]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, num_groups, cg)
    n = float(xf.shape[1] * cg)
    mean = xf.sum(dim=(1, 3)) / n  # [B, G]
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd[:, None, :, None] * gamma.float().reshape(num_groups, cg)
    y = (xf - mean[:, None, :, None]) * scale + beta.float().reshape(num_groups, cg)
    if activate:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)
