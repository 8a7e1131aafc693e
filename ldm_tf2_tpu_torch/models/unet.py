"""Epsilon-prediction U-Net (counterpart of ``ldm_tf2_tpu.models.unet.UNet``).

Structure: conv_in -> input blocks (num_blocks residual(+spatial
transformer) blocks per level, downsample between levels) -> middle
(res - spatial transformer - res) -> output blocks with U-skip concat ->
GroupNorm/SiLU/conv_out.  Spatial transformers run on every level except
the deepest, with num_heads heads of (model_channels/num_heads)*mult.

Numerics kept from the JAX package: symmetric [[1,1],[1,1]] pad before the
stride-2 downsample conv; nearest 2x + 3x3 conv upsample; GroupNorm eps
1e-5 in residual blocks and the head, 1e-6 inside SpatialTransformer;
cos-first sinusoidal time embedding; attention scale size_per_head**-0.5
after the QK product.

Dispatch: every spatial self-attention goes through the flash kernel
(``ops.flash_attention``), every FeedForward through the fused FFN kernel
(``ops.fused_ffn``); the 77-token cross-attention is plain PyTorch, or the
single-tile kernel (``ops.cross_attention``) under the JAX package's
opt-in switch ``ops.attention.set_packed_cross``.  The ResBlock chains and
the GroupNorms take the opt-in kernels of ``ops.fused_conv`` and
``ops.group_norm`` under those modules' switches.  Every kernel is
differentiable.

DeepCache (``forward(..., return_cache=True, cache_levels=k)`` and
``forward(..., shallow_cache=cache, cache_levels=k)``), as in the JAX
package: a full pass can also return ``h`` just before the first output
block of the ``k`` shallowest levels, and a shallow pass runs only those
levels' input blocks (without the last one's downsample), then their output
blocks from that cached tensor; the middle block and everything deeper are
skipped.  A shallow pass fed a fresh cache runs the same blocks on the same
tensors as the full pass.

Training mode (``forward(..., training=True, generator=g)``) applies the
JAX package's dropout, each mask drawn from ``g`` in forward order: a
ResidualBlock splits its second chain into GN+SiLU -> dropout -> conv ->
shortcut + h, and every CrossAttention drops its output, both at
``dropout_rate``; the FeedForward's rate is 0, so the fused FFN stays on
the training path.  ``training=False`` is the sampling path.

Serving modes (``set_serving_modes``, set by ``factory.apply_serving_modes``
from ``tpu.quantize`` / ``tpu.quantize_attention``): ``conv_quant`` sends the
ResBlock chains the JAX package's int8 gate claims through the W8A8 kernels
(``ops.quant_conv``), and ``attention_pv_int8`` runs the P.V product of the
self-attentions of 1024 or more tokens in int8.  Both are attributes of
the modules, so two models in one process do not share them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models import remat
from ldm_tf2_tpu_torch.models.layers import (
    Conv, Dense, GroupNorm, LayerNorm, Norm, Projection, dropout,
)
from ldm_tf2_tpu_torch.ops.attention import attention, use_packed_cross
from ldm_tf2_tpu_torch.ops.cross_attention import cross_attention
from ldm_tf2_tpu_torch.ops.flash_attention import spatial_self_attention
from ldm_tf2_tpu_torch.ops.fused_conv import conv3x3, gn_silu_conv3x3
from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn
from ldm_tf2_tpu_torch.ops.group_norm import group_norm
from ldm_tf2_tpu_torch.ops.quant_conv import int8_conv_weights
from ldm_tf2_tpu_torch.ops.resize import nearest_upsample_2x


def get_time_embedding(time, channels: int, max_time: float = 10000.0):
    """Sinusoidal timestep embedding, cos first: [B] -> [B, channels] f32."""
    half = channels // 2
    freqs = torch.exp(
        -math.log(max_time)
        * torch.arange(half, dtype=torch.float32, device=time.device) / half
    )
    args = time.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if channels % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Downsample(nn.Module):
    """Symmetric-pad stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels)

    def forward(self, x):
        return self.conv(x, stride=2, padding=1)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 SAME conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class ResidualBlock(nn.Module):
    """GN(1e-5)/SiLU/conv + time-MLP broadcast + GN/SiLU/(dropout)/conv +
    shortcut (a Dense projection when the channel count changes)."""

    def __init__(self, in_channels: int, channels: int, time_channels: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.group_norm_1 = Norm(in_channels)
        self.conv2d_1 = Conv(in_channels, channels)
        self.dense = Dense(time_channels, channels)
        self.group_norm_2 = Norm(channels)
        self.conv2d_2 = Conv(channels, channels)
        self.shortcut = (
            Dense(in_channels, channels) if in_channels != channels else None
        )
        self.set_conv_quant(False)

    def set_conv_quant(self, enabled: bool) -> None:
        """Switch the int8 chains on or off.  On, both conv kernels are
        quantized once, from the weights as stored, into non-persistent
        buffers (the weights are frozen at inference): switch it on after
        the weights are loaded and cast."""
        for i, conv in ((1, self.conv2d_1), (2, self.conv2d_2)):
            w8, ws = (int8_conv_weights(conv.kernel.detach()) if enabled
                      else (None, None))
            self.register_buffer(f"w8_{i}", w8, persistent=False)
            self.register_buffer(f"ws_{i}", ws, persistent=False)

    def forward(self, x, time_embedding, generator=None):
        t = self.dense(F.silu(time_embedding))
        q1, q2 = ((self.w8_1, self.ws_1), (self.w8_2, self.ws_2)) \
            if self.w8_1 is not None else (None, None)
        h = gn_silu_conv3x3(
            x, self.group_norm_1.scale, self.group_norm_1.bias,
            self.conv2d_1.kernel, self.conv2d_1.bias, time_add=t, eps=1e-5,
            int8_weights=q1,
        )
        shortcut = x if self.shortcut is None else self.shortcut(x)
        if generator is not None and self.dropout_rate > 0.0:
            g2 = self.group_norm_2
            h = group_norm(h, g2.scale, g2.bias, 32, 1e-5, activate=True)
            h = dropout(h, self.dropout_rate, generator)
            return shortcut + conv3x3(h, self.conv2d_2.kernel, self.conv2d_2.bias)
        return gn_silu_conv3x3(
            h, self.group_norm_2.scale, self.group_norm_2.bias,
            self.conv2d_2.kernel, self.conv2d_2.bias, residual_add=shortcut,
            eps=1e-5, int8_weights=q2,
        )


class CrossAttention(nn.Module):
    """q from the query, k/v from the context (self-attention when the
    context is None).  Self-attention takes the flash kernel (its int8-P.V
    form at 1024 or more tokens when ``pv_int8`` is set); attention to the
    short text context takes plain PyTorch, or the single-tile kernel when
    ``use_packed_cross`` says so.  The output is dropped at
    ``dropout_rate`` in training mode."""

    def __init__(self, num_heads: int, size_per_head: int,
                 hidden_size: int | None = None, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.scale = size_per_head**-0.5
        width = num_heads * size_per_head
        self.query = Projection(num_heads, size_per_head, width)
        self.key = Projection(num_heads, size_per_head, hidden_size)
        self.value = Projection(num_heads, size_per_head, hidden_size)
        self.output = Projection(num_heads, size_per_head, width,
                                 use_bias=True, mode="merge")
        self.pv_int8 = False

    def forward(self, query, context=None, generator=None):
        is_self = context is None
        context = query if is_self else context
        q, k, v = self.query(query), self.key(context), self.value(context)
        if is_self:
            out = spatial_self_attention(q, k, v, self.scale, self.pv_int8)
        elif use_packed_cross(q.shape[1], k.shape[1], q.shape[-1]):
            out = cross_attention(q, k, v, self.scale)
        else:
            out = attention(q, k, v, self.scale)
        return dropout(self.output(out), self.dropout_rate, generator)


class GEGLU(nn.Module):
    """value-Dense * gelu(gate-Dense): two leaves, as in the JAX package."""

    def __init__(self, in_features: int, channels: int):
        super().__init__()
        self.value = Dense(in_features, channels)
        self.gate = Dense(in_features, channels)


class FeedForward(nn.Module):
    """LN -> GEGLU(4C) -> Dense(C) -> +residual as one fused-FFN call; the
    LayerNorm params live in the parent block (``layernorm3``)."""

    def __init__(self, channels: int, multiplier: int = 4):
        super().__init__()
        hidden = channels * multiplier
        self.geglu = GEGLU(channels, hidden)
        self.dense = Dense(hidden, channels)

    def forward(self, x, ln_scale, ln_bias):
        dt = x.dtype
        g = self.geglu
        return fused_ffn(
            x, ln_scale.float(), ln_bias.float(),
            g.value.kernel.to(dt), g.value.bias.to(dt),
            g.gate.kernel.to(dt), g.gate.bias.to(dt),
            self.dense.kernel.to(dt), self.dense.bias.to(dt),
        )


class BasicTransformerBlock(nn.Module):
    """Pre-LN(1e-5): self-attn, cross-attn(context), GEGLU FFN, each with a
    residual add."""

    def __init__(self, num_heads: int, size_per_head: int, hidden_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        width = num_heads * size_per_head
        self.layernorm1 = LayerNorm(width)
        self.att_layer1 = CrossAttention(num_heads, size_per_head,
                                         dropout_rate=dropout_rate)
        self.layernorm2 = LayerNorm(width)
        self.att_layer2 = CrossAttention(num_heads, size_per_head, hidden_size,
                                         dropout_rate)
        self.layernorm3 = Norm(width)
        self.ffn = FeedForward(width)

    def forward(self, x, context=None, generator=None):
        x = self.att_layer1(self.layernorm1(x), generator=generator) + x
        x = self.att_layer2(self.layernorm2(x), context, generator) + x
        return self.ffn(x, self.layernorm3.scale, self.layernorm3.bias)


class SpatialTransformer(nn.Module):
    """GN(1e-6) -> proj_in -> [B,HW,C] transformer block -> proj_out -> +res."""

    def __init__(self, channels: int, num_heads: int, size_per_head: int,
                 hidden_size: int, dropout_rate: float = 0.0):
        super().__init__()
        width = num_heads * size_per_head
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Dense(channels, width)
        self.block = BasicTransformerBlock(num_heads, size_per_head, hidden_size,
                                           dropout_rate)
        self.proj_out = Dense(width, width)

    def forward(self, x, context=None, generator=None):
        b, h, w, c = x.shape
        y = self.proj_in(self.group_norm(x)).reshape(b, h * w, c)
        y = self.block(y, context, generator).reshape(b, h, w, c)
        return x + self.proj_out(y)


class InputBlock(nn.Module):
    """Residual(+spatial transformer), or a downsample."""

    def __init__(self, in_channels: int, channels: int, time_channels: int = 0,
                 use_spatial_transformer: bool = False,
                 use_downsample: bool = False, num_heads: int = 8,
                 size_per_head: int = 40, hidden_size: int = 512,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.use_downsample = use_downsample
        if use_downsample:
            self.downsample = Downsample(channels)
            return
        self.residual = ResidualBlock(in_channels, channels, time_channels,
                                      dropout_rate)
        self.spatial_transformer = (
            SpatialTransformer(channels, num_heads, size_per_head, hidden_size,
                               dropout_rate)
            if use_spatial_transformer else None
        )

    def forward(self, x, time_embedding=None, context=None, generator=None):
        if self.use_downsample:
            return self.downsample(x)
        x = self.residual(x, time_embedding, generator)
        if self.spatial_transformer is not None:
            x = self.spatial_transformer(x, context, generator)
        return x


class MiddleBlock(nn.Module):
    def __init__(self, channels, time_channels, context_channels, num_heads,
                 size_per_head, dropout_rate: float = 0.0):
        super().__init__()
        self.residual1 = ResidualBlock(channels, channels, time_channels,
                                       dropout_rate)
        self.spatial_transformer = SpatialTransformer(
            channels, num_heads, size_per_head, context_channels, dropout_rate
        )
        self.residual2 = ResidualBlock(channels, channels, time_channels,
                                       dropout_rate)

    def forward(self, x, time_embedding, context, generator=None):
        x = self.residual1(x, time_embedding, generator)
        x = self.spatial_transformer(x, context, generator)
        return self.residual2(x, time_embedding, generator)


class OutputBlock(nn.Module):
    """Residual(+spatial transformer)(+upsample)."""

    def __init__(self, in_channels, channels, time_channels,
                 use_spatial_transformer, use_upsample, num_heads,
                 size_per_head, hidden_size, dropout_rate: float = 0.0):
        super().__init__()
        self.residual = ResidualBlock(in_channels, channels, time_channels,
                                      dropout_rate)
        self.spatial_transformer = (
            SpatialTransformer(channels, num_heads, size_per_head, hidden_size,
                               dropout_rate)
            if use_spatial_transformer else None
        )
        self.upsample = Upsample(channels) if use_upsample else None

    def forward(self, x, time_embedding, context=None, generator=None):
        x = self.residual(x, time_embedding, generator)
        if self.spatial_transformer is not None:
            x = self.spatial_transformer(x, context, generator)
        if self.upsample is not None:
            x = self.upsample(x)
        return x


class UNet(nn.Module):
    """Text-conditioned epsilon predictor.  ``attention_resolutions`` is
    accepted for config parity; the placement rule is "spatial transformers
    on every level except the deepest".  ``dropout_rate`` applies only in
    training mode."""

    def __init__(self, model_channels: int = 320, out_channels: int = 4,
                 num_blocks: int = 2, attention_resolutions=(4, 2, 1),
                 dropout_rate: float = 0.1, channel_mult=(1, 2, 4, 4),
                 num_heads: int = 8, context_channels: int = 1280,
                 in_channels: int = 4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.model_channels = model_channels
        self.num_blocks = num_blocks
        self.channel_mult = tuple(channel_mult)
        mc, levels = model_channels, len(channel_mult)
        tc = mc * 4
        self.conv_in = Conv(in_channels, mc)
        self.time_dense1 = Dense(mc, tc)
        self.time_dense2 = Dense(tc, tc)

        skips, ch, idx = [mc], mc, 0
        for i, mult in enumerate(channel_mult):
            for _ in range(num_blocks):
                self.add_module(f"input_block_{idx}", InputBlock(
                    ch, mc * mult, tc, use_spatial_transformer=i < levels - 1,
                    num_heads=num_heads,
                    size_per_head=(mc // num_heads) * mult,
                    hidden_size=context_channels, dropout_rate=dropout_rate,
                ))
                ch = mc * mult
                skips.append(ch)
                idx += 1
            if i < levels - 1:
                self.add_module(f"input_block_{idx}",
                                InputBlock(ch, ch, use_downsample=True))
                skips.append(ch)
                idx += 1
        self.num_input_blocks = idx
        self.middle_block = MiddleBlock(
            ch, tc, context_channels, num_heads,
            (mc // num_heads) * channel_mult[-1], dropout_rate,
        )
        idx = 0
        for i, mult in list(enumerate(channel_mult))[::-1]:
            for j in range(num_blocks + 1):
                self.add_module(f"output_block_{idx}", OutputBlock(
                    ch + skips.pop(), mc * mult, tc,
                    use_spatial_transformer=i < levels - 1,
                    use_upsample=i > 0 and j == num_blocks,
                    num_heads=num_heads,
                    size_per_head=(mc // num_heads) * mult,
                    hidden_size=context_channels, dropout_rate=dropout_rate,
                ))
                ch = mc * mult
                idx += 1
        self.num_output_blocks = idx
        self.group_norm = GroupNorm(ch, eps=1e-5, activate=True)
        self.conv_out = Conv(ch, out_channels)
        self.conv_quant = False
        self.attention_pv_int8 = False

    def set_serving_modes(self, conv_quant: bool = False,
                          attention_pv_int8: bool = False) -> None:
        """The int8 serving modes (``tpu.quantize: int8``,
        ``tpu.quantize_attention: int8pv``), pushed down to every ResBlock
        and self-attention.  Call it after the weights are loaded and cast:
        the int8 conv weights are taken from them once."""
        self.conv_quant = bool(conv_quant)
        self.attention_pv_int8 = bool(attention_pv_int8)
        for m in self.modules():
            if isinstance(m, ResidualBlock):
                m.set_conv_quant(self.conv_quant)
            elif isinstance(m, CrossAttention):
                m.pv_int8 = self.attention_pv_int8

    def forward(self, x, time, context=None, *, training: bool = False,
                generator=None, shallow_cache=None, return_cache: bool = False,
                cache_levels: int = 1, remat_blocks: bool = False):
        """x: [B, H, W, C] latents (NHWC); time: [B]; context: [B, S, D].
        Returns [B, H, W, out_channels] predicted noise; with
        ``return_cache``, ``(noise, cache)``.  ``training`` with a nonzero
        ``dropout_rate`` draws the dropout masks from ``generator``.
        ``shallow_cache`` (a cache from a ``return_cache`` pass) runs the
        shallow pass of the ``cache_levels`` outermost levels (1 ..
        levels - 1).  ``remat_blocks`` runs each input, middle and output
        block as its own checkpoint segment (``models/remat.py``, the
        trainer's "blocks" policy), replaying its draws from ``generator``
        in the recompute."""
        levels = len(self.channel_mult)
        shallow = shallow_cache is not None
        if (shallow or return_cache) and not 1 <= cache_levels <= levels - 1:
            raise ValueError(
                f"cache_levels must be in [1, {levels - 1}], got {cache_levels}"
            )
        if shallow and return_cache:
            raise ValueError("a shallow pass cannot produce a cache")
        if training and self.dropout_rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        gen = generator if training else None
        per_level = self.num_blocks + 1  # residual blocks and a resample
        # the first output block of the cache_levels outermost levels
        boundary = (levels - cache_levels) * per_level
        h = self.conv_in(x.to(self.dtype))
        t = get_time_embedding(time, self.model_channels).to(self.dtype)
        t = self.time_dense2(F.silu(self.time_dense1(t)))
        context = None if context is None else context.to(self.dtype)

        def block(module, h, skip=None):
            """One block on h (concatenated with its skip input), a
            checkpoint segment of its own under ``remat_blocks``."""
            if skip is None:
                run, args = (lambda g, h: module(h, t, context, g)), (h,)
            else:
                run = lambda g, h, s: module(torch.cat([h, s], dim=-1), t, context, g)
                args = (h, skip)
            if remat_blocks:
                return remat.checkpoint(run, gen, *args)
            return run(gen, *args)

        hiddens = [h]
        # a shallow pass stops before the downsample of level cache_levels-1
        n_in = cache_levels * per_level - 1 if shallow else self.num_input_blocks
        for i in range(n_in):
            h = block(getattr(self, f"input_block_{i}"), h)
            hiddens.append(h)
        if shallow:
            h = shallow_cache.to(self.dtype)
        else:
            h = block(self.middle_block, h)
        cache = None
        for i in range(boundary if shallow else 0, self.num_output_blocks):
            if return_cache and i == boundary:
                cache = h
            h = block(getattr(self, f"output_block_{i}"), h, hiddens.pop())
        out = self.conv_out(self.group_norm(h))
        return (out, cache) if return_cache else out
