"""Nearest-neighbour 2x upsample with TF ``ResizeNearestNeighbor
(align_corners=False)`` semantics (counterpart of
``ldm_tf2_tpu.ops.resize.nearest_upsample_2x``)."""

from __future__ import annotations


def nearest_upsample_2x(x):
    """Each pixel of an NHWC tensor becomes a 2x2 block."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)
