"""Multi-head dot-product attention, plain PyTorch.

Layout contract, the same as ``ldm_tf2_tpu.ops.attention``:
  q: [B, Q, H, S]   k, v: [B, C, H, S]   out: [B, Q, H, S]
with the logits computed in float32 and scaled by ``scale`` *after* the QK
contraction (the JAX package's ``_xla_attention``).

This is the path for short key sequences: the 77-token cross-attention of
the U-Net and the text encoder's self-attention.  Long spatial
self-attention goes through the flash kernel (``ops.flash_attention``),
chosen by the calling module, not by a length threshold here.

``set_packed_cross(True)`` keeps the JAX package's switch of that name: the
U-Net's cross-attentions then take the single-tile kernel
(``ops.cross_attention``) where ``use_packed_cross`` says so.  It is off by
default, as in the JAX package.
"""

from __future__ import annotations

import torch

_PACKED_CROSS_ENABLED = False


def set_packed_cross(flag: bool) -> None:
    """A/B switch for the fused short-kv cross-attention kernel."""
    global _PACKED_CROSS_ENABLED
    _PACKED_CROSS_ENABLED = bool(flag)


def use_packed_cross(q_len: int, kv_len: int, size_per_head: int) -> bool:
    """True when the switch is on and the kernel takes the shape
    (``ops.cross_attention.kernel_takes``).  The JAX package's extra
    conditions are TPU measurements (a 256-query minimum) or TPU-only
    (the backend, sequence parallelism), and are not copied."""
    from ldm_tf2_tpu_torch.ops.cross_attention import kernel_takes

    return _PACKED_CROSS_ENABLED and kernel_takes(q_len, kv_len, size_per_head)


def dot_product_attention(q, k, v, scale: float):
    """Scaled dot-product attention, [B,Q,H,S] x [B,C,H,S] -> [B,Q,H,S]."""
    logits = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqc,bchs->bqhs", weights, v)
