"""KL- and VQ-regularized convolutional autoencoders (counterparts of
``ldm_tf2_tpu.models.autoencoder.AutoencoderKL`` and ``AutoencoderVQ``).

Numerics kept from the JAX package: GroupNorm(32, eps=1e-6) throughout; the
encoder's downsample pads asymmetrically [[0,1],[0,1]] before its stride-2
VALID conv (or average-pools without ``resample_with_conv``); the decoder
upsamples nearest 2x (+ a 3x3 conv); the residual shortcut is a Dense
projection made only when the channel count changes.  Attention blocks
sit where the spatial size is in ``attention_resolutions`` (the VQ model's
32^2 level; the KL model places none, as in the JAX package), a test the
JAX package makes at call time on the input's size: here the blocks are
built for the image size ``resolution`` and the same test runs at call
time.  The single-head attentions go through the flash kernel, in its
int8-P.V form at 1024 or more tokens when ``attention_pv_int8`` is set
(``set_serving_modes``).  The int8 conv chains never apply here: the
ResBlocks pass no int8 weights, as the JAX package's autoencoder opts out.
The chains and GroupNorms take the opt-in kernels under the switches of
``ops.fused_conv`` and ``ops.group_norm``, as in the JAX package.

Training mode is a ``generator`` passed to ``encode``/``decode``: each
ResidualBlock then splits its second chain into GN+SiLU -> dropout ->
conv -> +shortcut, as the JAX package does, the masks drawn from the
generator in forward order (the configs' rate is 0, which keeps the
fused chain).  ``last_layer`` is the decoder's final conv kernel, which
the adaptive GAN weight differentiates against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models.distribution import DiagonalGaussian
from ldm_tf2_tpu_torch.models.layers import (
    Conv, Dense, GroupNorm, Norm, dropout,
)
from ldm_tf2_tpu_torch.models.quantize import VectorQuantizer
from ldm_tf2_tpu_torch.ops.flash_attention import spatial_self_attention
from ldm_tf2_tpu_torch.ops.fused_conv import conv3x3, gn_silu_conv3x3
from ldm_tf2_tpu_torch.ops.group_norm import group_norm
from ldm_tf2_tpu_torch.ops.resize import nearest_upsample_2x

GROUP_NORM_EPS = 1e-6


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.group_norm1 = Norm(in_channels)
        self.conv1 = Conv(in_channels, channels)
        self.group_norm2 = Norm(channels)
        self.conv2 = Conv(channels, channels)
        self.shortcut = (
            Dense(in_channels, channels) if in_channels != channels else None
        )

    def forward(self, x, generator=None):
        h = gn_silu_conv3x3(
            x, self.group_norm1.scale, self.group_norm1.bias,
            self.conv1.kernel, self.conv1.bias, eps=GROUP_NORM_EPS,
        )
        shortcut = x if self.shortcut is None else self.shortcut(x)
        if generator is not None and self.dropout_rate > 0.0:
            g2 = self.group_norm2
            h = group_norm(h, g2.scale, g2.bias, 32, GROUP_NORM_EPS, activate=True)
            h = dropout(h, self.dropout_rate, generator)
            return shortcut + conv3x3(h, self.conv2.kernel, self.conv2.bias)
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
    """Asymmetric [[0,1],[0,1]] pad, then a stride-2 VALID 3x3 conv; a 2x2
    average pool without ``with_conv``."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.conv = Conv(channels, channels) if with_conv else None

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding=0)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 SAME conv unless ``with_conv`` is off."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.conv = Conv(channels, channels) if with_conv else None

    def forward(self, x):
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class ResAttnBlock(nn.Module):
    """A residual block, then attention when the input's spatial size is in
    ``attention_resolutions``; the attention block is built when the size
    the model is built for, ``resolution``, is."""

    def __init__(self, in_channels: int, channels: int, attention_resolutions=(),
                 resolution: int = 0, dropout_rate: float = 0.0):
        super().__init__()
        self.attention_resolutions = tuple(attention_resolutions)
        self.residual = ResidualBlock(in_channels, channels, dropout_rate)
        self.attention = (AttentionBlock(channels)
                          if resolution in self.attention_resolutions else None)

    def forward(self, x, generator=None):
        x = self.residual(x, generator)
        if x.shape[1] in self.attention_resolutions:
            if self.attention is None:
                raise ValueError(
                    f"a {x.shape[1]}x{x.shape[2]} map asks for attention where "
                    "this model was built without it: build it for this image "
                    "size (resolution=)"
                )
            x = self.attention(x)
        return x


class MiddleBlock(nn.Module):
    def __init__(self, channels: int, dropout_rate: float = 0.0):
        super().__init__()
        self.residual1 = ResidualBlock(channels, channels, dropout_rate)
        self.attention = AttentionBlock(channels)
        self.residual2 = ResidualBlock(channels, channels, dropout_rate)

    def forward(self, x, generator=None):
        return self.residual2(self.attention(self.residual1(x, generator)),
                              generator)


class Encoder(nn.Module):
    def __init__(self, channels, num_blocks, latent_channels, multipliers,
                 attention_resolutions=(), resolution=0, dropout_rate=0.0,
                 resample_with_conv=True, in_channels=3):
        super().__init__()
        self.conv_in = Conv(in_channels, channels)
        self.names = []
        ch, idx, res = channels, 0, resolution
        for i, mult in enumerate(multipliers):
            for _ in range(num_blocks):
                self.add_module(f"down_{idx}", ResAttnBlock(
                    ch, channels * mult, attention_resolutions, res, dropout_rate))
                ch = channels * mult
                self.names.append(f"down_{idx}")
                idx += 1
            if i < len(multipliers) - 1:
                self.add_module(f"down_{idx}", Downsample(ch, resample_with_conv))
                self.names.append(f"down_{idx}")
                idx += 1
                res //= 2
        self.middle = MiddleBlock(ch, dropout_rate)
        self.group_norm = GroupNorm(ch, eps=GROUP_NORM_EPS, activate=True)
        self.conv_out = Conv(ch, latent_channels)

    def forward(self, x, generator=None):
        x = self.conv_in(x)
        for name in self.names:
            block = getattr(self, name)
            x = block(x) if isinstance(block, Downsample) else block(x, generator)
        return self.conv_out(self.group_norm(self.middle(x, generator)))


class Decoder(nn.Module):
    def __init__(self, channels, out_channels, num_blocks, multipliers,
                 latent_channels, attention_resolutions=(), resolution=0,
                 dropout_rate=0.0, resample_with_conv=True):
        super().__init__()
        chans = [channels * m for m in multipliers]
        self.conv_in = Conv(latent_channels, chans[-1])
        self.middle = MiddleBlock(chans[-1], dropout_rate)
        self.names = []
        ch, idx = chans[-1], 0
        res = resolution // 2 ** (len(multipliers) - 1)
        for i in reversed(range(len(multipliers))):
            for _ in range(num_blocks + 1):
                self.add_module(f"up_{idx}", ResAttnBlock(
                    ch, chans[i], attention_resolutions, res, dropout_rate))
                ch = chans[i]
                self.names.append(f"up_{idx}")
                idx += 1
            if i > 0:
                self.add_module(f"up_{idx}", Upsample(ch, resample_with_conv))
                self.names.append(f"up_{idx}")
                idx += 1
                res *= 2
        self.group_norm = GroupNorm(ch, eps=GROUP_NORM_EPS, activate=True)
        self.conv_out = Conv(ch, out_channels)

    def forward(self, x, generator=None):
        x = self.middle(self.conv_in(x), generator)
        for name in self.names:
            block = getattr(self, name)
            x = block(x) if isinstance(block, Upsample) else block(x, generator)
        return self.conv_out(self.group_norm(x))


class _Autoencoder(nn.Module):
    """What the two autoencoders share: the serving mode and the last
    layer."""

    def set_serving_modes(self, attention_pv_int8: bool = False) -> None:
        """``tpu.quantize_attention: int8pv`` for the self-attentions."""
        self.attention_pv_int8 = bool(attention_pv_int8)
        for m in self.modules():
            if isinstance(m, AttentionBlock):
                m.pv_int8 = self.attention_pv_int8

    def last_layer(self) -> nn.Parameter:
        """The decoder's final conv kernel (the JAX package's
        ``last_layer_path()``), for the adaptive GAN weight."""
        return self.decoder.conv_out.kernel


class AutoencoderKL(_Autoencoder):
    """KL-regularized autoencoder (f8 at the default config).
    ``attention_resolutions`` is accepted for config parity and places no
    attention, as in the JAX package."""

    def __init__(self, latent_channels: int = 4, channels: int = 128,
                 num_blocks: int = 2, attention_resolutions=(),
                 dropout_rate: float = 0.0, multipliers=(1, 2, 4, 4),
                 resample_with_conv: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(channels, num_blocks, latent_channels * 2,
                               multipliers, dropout_rate=dropout_rate,
                               resample_with_conv=resample_with_conv)
        self.quant_conv = Dense(latent_channels * 2, latent_channels * 2)
        self.post_quant_conv = Dense(latent_channels, latent_channels)
        self.decoder = Decoder(channels, 3, num_blocks, multipliers,
                               latent_channels, dropout_rate=dropout_rate,
                               resample_with_conv=resample_with_conv)
        self.attention_pv_int8 = False

    def encode(self, x, generator=None) -> DiagonalGaussian:
        """The posterior; training mode (dropout) when ``generator`` is
        given."""
        h = self.quant_conv(self.encoder(x.to(self.dtype), generator))
        mean, logvar = torch.chunk(h, 2, dim=-1)
        return DiagonalGaussian.create(mean, logvar)

    def decode(self, z, generator=None):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)), generator)


class AutoencoderVQ(_Autoencoder):
    """VQ-regularized autoencoder, its attention blocks built for images of
    ``resolution`` (256 at the repo's config)."""

    def __init__(self, latent_channels: int = 4, channels: int = 128,
                 num_blocks: int = 2, dropout_rate: float = 0.0,
                 multipliers=(1, 2, 2, 4), resample_with_conv: bool = True,
                 attention_resolutions=(32,), vocab_size: int = 16384,
                 beta: float = 0.25, resolution: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(channels, num_blocks, latent_channels, multipliers,
                               attention_resolutions, resolution, dropout_rate,
                               resample_with_conv)
        self.quant_conv = Dense(latent_channels, latent_channels)
        self.quantize = VectorQuantizer(vocab_size, latent_channels, beta)
        self.post_quant_conv = Dense(latent_channels, latent_channels)
        self.decoder = Decoder(channels, 3, num_blocks, multipliers,
                               latent_channels, attention_resolutions, resolution,
                               dropout_rate, resample_with_conv)
        self.attention_pv_int8 = False

    def encode(self, x, only_encode: bool = False, generator=None):
        """The latents before quantization when ``only_encode``, else the
        quantizer's (quantized, codebook_loss, indices)."""
        z = self.quant_conv(self.encoder(x.to(self.dtype), generator))
        return z if only_encode else self.quantize(z)

    def decode(self, z, force_quantize: bool = False, generator=None):
        """Decode latents, quantizing them first when ``force_quantize`` (the
        sampling path; the JAX package keeps only the quantized tensor of
        the quantizer's 3-tuple, where its reference kept the tuple)."""
        z = z.to(self.dtype)
        if force_quantize:
            z = self.quantize(z)[0]
        return self.decoder(self.post_quant_conv(z), generator)
