"""The ResBlock chain GN -> SiLU -> 3x3 SAME conv -> +bias, +time, +residual.

Counterpart of ``ldm_tf2_tpu.ops.fused_conv.gn_silu_conv3x3`` on its
default path (``_xla_ref``): the JAX package leaves this convolution to XLA
outside any Pallas kernel, so the port leaves it to ``F.conv2d``.  In the
int8 serving mode the chains the JAX package's gate claims take the W8A8
route of ``ops.quant_conv`` instead.

Activations are NHWC.  Convolution kernels are in PyTorch's OIHW order
(the checkpoint bridge transposes the JAX package's HWIO kernels once, at
load time).  An NHWC tensor permuted to NCHW is a channels-last NCHW view,
so no activation is copied on either side of the convolution.
"""

from __future__ import annotations

import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops.group_norm import group_norm
from ldm_tf2_tpu_torch.ops.quant_conv import gn_silu_conv3x3_int8, use_int8_conv


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0):
    """NHWC convolution with an OIHW kernel; weights cast to x's dtype."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype),
        None if b is None else b.to(x.dtype), stride=stride, padding=padding,
    )
    return out.permute(0, 2, 3, 1)


def conv3x3(y, w, b):
    """3x3 SAME convolution (stride 1) of NHWC ``y`` with OIHW ``w``."""
    return conv2d(y, w, b, padding=1)


def gn_silu_conv3x3(x, gamma, beta, w, b, *, time_add=None, residual_add=None,
                    num_groups: int = 32, eps: float = 1e-5,
                    int8_weights=None):
    """GroupNorm -> SiLU -> 3x3 SAME conv (+bias, +optional epilogues).

    x: [B, H, W, Cin]; gamma, beta: [Cin]; w: [Cout, Cin, 3, 3]; b: [Cout];
    time_add: optional [B, Cout]; residual_add: optional [B, H, W, Cout].
    int8_weights: ``quant_conv.int8_conv_weights(w)`` when the int8 serving
    mode is on for the caller (the U-Net's ResBlocks; the autoencoder's
    never pass them, as the JAX package's never opt in), else None.  The
    chain then takes the W8A8 route where the JAX package's shape gate
    ``use_int8_conv`` claims it.
    """
    if int8_weights is not None and use_int8_conv(
        x.shape, w.shape[0], num_groups, has_add=residual_add is not None,
    ):
        w8, ws = int8_weights
        return gn_silu_conv3x3_int8(
            x, gamma, beta, w8, ws, b, time_add=time_add,
            residual_add=residual_add, num_groups=num_groups, eps=eps,
        )
    y = group_norm(x, gamma, beta, num_groups, eps, activate=True)
    out = conv3x3(y, w, b)
    if time_add is not None:
        out = out + time_add[:, None, None, :].to(out.dtype)
    if residual_add is not None:
        out = out + residual_add.to(out.dtype)
    return out
