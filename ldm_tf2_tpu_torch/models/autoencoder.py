"""KL-regularized convolutional autoencoder (counterpart of
``ldm_tf2_tpu.models.autoencoder.AutoencoderKL``).

Numerics kept from the JAX package: GroupNorm(32, eps=1e-6) throughout; the
encoder's downsample pads asymmetrically [[0,1],[0,1]] before its stride-2
VALID conv; the decoder upsamples nearest 2x + 3x3 conv; the residual
shortcut is a Dense projection made only when the channel count changes.
The single-head mid-block attention goes through the flash kernel, in
its int8-P.V form at 1024 or more tokens when ``attention_pv_int8`` is set
(``set_serving_modes``).  The int8 conv chains never apply here: the
ResBlocks pass no int8 weights, as the JAX package's autoencoder opts out.
The chains and GroupNorms take the opt-in kernels under the switches of
``ops.fused_conv`` and ``ops.group_norm``, as in the JAX package.
``AutoencoderVQ`` is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models.distribution import DiagonalGaussian
from ldm_tf2_tpu_torch.models.layers import Conv, Dense, GroupNorm, Norm
from ldm_tf2_tpu_torch.ops.flash_attention import spatial_self_attention
from ldm_tf2_tpu_torch.ops.fused_conv import gn_silu_conv3x3
from ldm_tf2_tpu_torch.ops.resize import nearest_upsample_2x

GROUP_NORM_EPS = 1e-6


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.group_norm1 = Norm(in_channels)
        self.conv1 = Conv(in_channels, channels)
        self.group_norm2 = Norm(channels)
        self.conv2 = Conv(channels, channels)
        self.shortcut = (
            Dense(in_channels, channels) if in_channels != channels else None
        )

    def forward(self, x):
        h = gn_silu_conv3x3(
            x, self.group_norm1.scale, self.group_norm1.bias,
            self.conv1.kernel, self.conv1.bias, eps=GROUP_NORM_EPS,
        )
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return gn_silu_conv3x3(
            h, self.group_norm2.scale, self.group_norm2.bias,
            self.conv2.kernel, self.conv2.bias, residual_add=shortcut,
            eps=GROUP_NORM_EPS,
        )


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention over H*W tokens of width C,
    scale C**-0.5, through the flash kernel (int8 P.V when ``pv_int8``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, eps=GROUP_NORM_EPS)
        self.query = Dense(channels, channels)
        self.key = Dense(channels, channels)
        self.value = Dense(channels, channels)
        self.output = Dense(channels, channels)
        self.pv_int8 = False

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x)
        shape = (b, h * w, 1, c)
        out = spatial_self_attention(
            self.query(y).reshape(shape), self.key(y).reshape(shape),
            self.value(y).reshape(shape), c**-0.5, self.pv_int8,
        ).reshape(b, h, w, c)
        return x + self.output(out)


class Downsample(nn.Module):
    """Asymmetric [[0,1],[0,1]] pad, then a stride-2 VALID 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding=0)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class ResAttnBlock(nn.Module):
    """A residual block (the KL autoencoder places no attention here)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.residual = ResidualBlock(in_channels, channels)

    def forward(self, x):
        return self.residual(x)


class MiddleBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.residual1 = ResidualBlock(channels, channels)
        self.attention = AttentionBlock(channels)
        self.residual2 = ResidualBlock(channels, channels)

    def forward(self, x):
        return self.residual2(self.attention(self.residual1(x)))


class Encoder(nn.Module):
    def __init__(self, channels, num_blocks, latent_channels, multipliers,
                 in_channels=3):
        super().__init__()
        self.conv_in = Conv(in_channels, channels)
        self.names = []
        ch, idx = channels, 0
        for i, mult in enumerate(multipliers):
            for _ in range(num_blocks):
                self.add_module(f"down_{idx}", ResAttnBlock(ch, channels * mult))
                ch = channels * mult
                self.names.append(f"down_{idx}")
                idx += 1
            if i < len(multipliers) - 1:
                self.add_module(f"down_{idx}", Downsample(ch))
                self.names.append(f"down_{idx}")
                idx += 1
        self.middle = MiddleBlock(ch)
        self.group_norm = GroupNorm(ch, eps=GROUP_NORM_EPS, activate=True)
        self.conv_out = Conv(ch, latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(self.group_norm(self.middle(x)))


class Decoder(nn.Module):
    def __init__(self, channels, out_channels, num_blocks, multipliers,
                 latent_channels):
        super().__init__()
        chans = [channels * m for m in multipliers]
        self.conv_in = Conv(latent_channels, chans[-1])
        self.middle = MiddleBlock(chans[-1])
        self.names = []
        ch, idx = chans[-1], 0
        for i in reversed(range(len(multipliers))):
            for _ in range(num_blocks + 1):
                self.add_module(f"up_{idx}", ResAttnBlock(ch, chans[i]))
                ch = chans[i]
                self.names.append(f"up_{idx}")
                idx += 1
            if i > 0:
                self.add_module(f"up_{idx}", Upsample(ch))
                self.names.append(f"up_{idx}")
                idx += 1
        self.group_norm = GroupNorm(ch, eps=GROUP_NORM_EPS, activate=True)
        self.conv_out = Conv(ch, out_channels)

    def forward(self, x):
        x = self.middle(self.conv_in(x))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(self.group_norm(x))


class AutoencoderKL(nn.Module):
    """KL-regularized autoencoder (f8 at the default config).
    ``attention_resolutions`` must be empty, as in every KL config;
    ``dropout_rate`` and ``resample_with_conv`` are accepted for config
    parity (sampling never drops; resampling is always by conv)."""

    def __init__(self, latent_channels: int = 4, channels: int = 128,
                 num_blocks: int = 2, attention_resolutions=(),
                 dropout_rate: float = 0.0, multipliers=(1, 2, 4, 4),
                 resample_with_conv: bool = True, dtype=torch.float32):
        super().__init__()
        if tuple(attention_resolutions) or not resample_with_conv:
            raise NotImplementedError(
                "AutoencoderKL supports attention_resolutions=[] and "
                "resample_with_conv=true only"
            )
        self.dtype = dtype
        self.encoder = Encoder(channels, num_blocks, latent_channels * 2,
                               multipliers)
        self.quant_conv = Dense(latent_channels * 2, latent_channels * 2)
        self.post_quant_conv = Dense(latent_channels, latent_channels)
        self.decoder = Decoder(channels, 3, num_blocks, multipliers,
                               latent_channels)
        self.attention_pv_int8 = False

    def set_serving_modes(self, attention_pv_int8: bool = False) -> None:
        """``tpu.quantize_attention: int8pv`` for the mid-block
        attentions."""
        self.attention_pv_int8 = bool(attention_pv_int8)
        for m in self.modules():
            if isinstance(m, AttentionBlock):
                m.pv_int8 = self.attention_pv_int8

    def encode(self, x) -> DiagonalGaussian:
        h = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = torch.chunk(h, 2, dim=-1)
        return DiagonalGaussian.create(mean, logvar)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
