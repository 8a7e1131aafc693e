"""Parameter-holding layers whose names and shapes mirror the JAX package's
flax modules, so a flax param tree maps onto a ``state_dict`` by joining
its keys with dots (``checkpoints/bridge.py``).

Layouts: Dense kernels [in, out]; Projection kernels [D, H, S] (split) and
[H, S, D] (merge); convolution kernels OIHW (the bridge transposes the
JAX package's HWIO once).  Parameters are created uninitialized: they are
filled by the bridge or by ``factory.randomize_``.  Weights are cast to the
activation dtype where they are used, as flax's ``dtype=`` does; norm
parameters are applied in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ldm_tf2_tpu_torch.ops.fused_conv import conv2d
from ldm_tf2_tpu_torch.parallel import rng
from ldm_tf2_tpu_torch.ops.group_norm import group_norm


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


def dropout(x, rate: float, generator):
    """flax ``nn.Dropout`` in training mode: keep each element with
    probability 1 - rate (a uniform draw from ``generator``, a
    ``torch.Generator`` or a ``parallel.RowSlice``, below it) and scale the
    kept ones by 1 / (1 - rate).  Identity when ``generator`` is None (not
    training) or the rate is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rng.rand(x.shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__()
        self.kernel = _param(in_features, features)
        self.bias = _param(features) if bias else None

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Conv(nn.Module):
    """kxk convolution over NHWC activations with an OIHW kernel."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.kernel = _param(features, in_features, kernel_size, kernel_size)
        self.bias = _param(features) if bias else None

    def forward(self, x, stride: int = 1, padding: int = 1):
        return conv2d(x, self.kernel, self.bias, stride=stride, padding=padding)


class Norm(nn.Module):
    """``scale``/``bias`` of [C] (a flax GroupNorm's or LayerNorm's params)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = _param(features)
        self.bias = _param(features)


class GroupNorm(Norm):
    def __init__(self, features: int, eps: float, activate: bool = False,
                 num_groups: int = 32):
        super().__init__(features)
        self.eps, self.activate, self.num_groups = eps, activate, num_groups

    def forward(self, x):
        return group_norm(x, self.scale, self.bias, self.num_groups, self.eps,
                          self.activate)


def layer_norm(x, scale, bias, eps: float):
    """flax ``nn.LayerNorm``: float32 statistics with the *fast* variance
    E[x^2]-E[x]^2 clamped at 0 (``F.layer_norm`` is two-pass)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(x.dtype)


class LayerNorm(Norm):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features)
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = _param(num, features)

    def forward(self, ids, dtype):
        return self.embedding.to(dtype)[ids]


class Projection(nn.Module):
    """Head split/merge dense (``ldm_tf2_tpu.models.transformer.Projection``,
    unpacked layout).

    split: [B,T,D] x [D,H,S] -> [B,T,H,S];  merge: [B,T,H,S] x [H,S,D] -> [B,T,D]
    """

    def __init__(self, num_heads: int, size_per_head: int,
                 hidden_size: int | None = None, use_bias: bool = False,
                 mode: str = "split"):
        super().__init__()
        if mode not in ("split", "merge"):
            raise ValueError('"mode" must be either "split" or "merge".')
        hidden = num_heads * size_per_head if hidden_size is None else hidden_size
        self.mode, self.num_heads, self.size_per_head = mode, num_heads, size_per_head
        if mode == "merge":
            self.kernel = _param(num_heads, size_per_head, hidden)
            self.bias = _param(hidden) if use_bias else None
        else:
            self.kernel = _param(hidden, num_heads, size_per_head)
            self.bias = _param(size_per_head) if use_bias else None

    def forward(self, x):
        if self.mode == "merge":
            b, t = x.shape[:2]
            k = self.kernel.to(x.dtype)
            out = x.reshape(b, t, -1) @ k.reshape(-1, k.shape[-1])
        else:
            k = self.kernel.to(x.dtype)
            out = (x @ k.reshape(k.shape[0], -1)).reshape(
                *x.shape[:-1], self.num_heads, self.size_per_head
            )
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out
