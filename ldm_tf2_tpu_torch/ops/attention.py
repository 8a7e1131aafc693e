"""Multi-head dot-product attention, plain PyTorch.

Layout contract, the same as ``ldm_tf2_tpu.ops.attention``:
  q: [B, Q, H, S]   k, v: [B, C, H, S]   out: [B, Q, H, S]
with the logits computed in float32 and scaled by ``scale`` *after* the QK
contraction (the JAX package's ``_xla_attention``).

This is the path for short key sequences: the 77-token cross-attention of
the U-Net and the text encoder's self-attention.  Long spatial
self-attention goes through the flash kernel (``ops.flash_attention``),
chosen by the calling module, not by a length threshold here.
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, scale: float):
    """Scaled dot-product attention, [B,Q,H,S] x [B,C,H,S] -> [B,Q,H,S]."""
    logits = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqc,bchs->bqhs", weights, v)
