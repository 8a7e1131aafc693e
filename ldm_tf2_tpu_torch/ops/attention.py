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

``set_attention_impl`` keeps the JAX package's ``tpu.attention_impl``
("auto", "xla", "flash"; ``factory.apply_tpu_settings`` applies the config
key).  "xla" sends every spatial self-attention of the U-Net and the
autoencoder to ``dot_product_attention`` on either device, and then the
int8-P.V mode and the packed cross switch have no effect, as in the JAX
package; "flash" takes the kernel for every spatial self-attention, of any
length, as the JAX package's ``_use_flash`` does; "auto" is the port's
default route (``ops.flash_attention.spatial_self_attention``).  The
calling module makes the choice, not the kernel wrapper.
"""

from __future__ import annotations

import torch

_PACKED_CROSS_ENABLED = False
_ATTENTION_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    """Select the attention implementation: "xla", "flash", or "auto"."""
    global _ATTENTION_IMPL
    if impl not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    _ATTENTION_IMPL = impl


def get_attention_impl() -> str:
    return _ATTENTION_IMPL


def set_packed_cross(flag: bool) -> None:
    """A/B switch for the fused short-kv cross-attention kernel."""
    global _PACKED_CROSS_ENABLED
    _PACKED_CROSS_ENABLED = bool(flag)


def use_packed_cross(q_len: int, kv_len: int, size_per_head: int) -> bool:
    """True when the switch is on, ``attention_impl`` is not "xla" and the
    kernel takes the shape (``ops.cross_attention.kernel_takes``).  The JAX package's extra
    conditions are TPU measurements (a 256-query minimum) or TPU-only
    (the backend, sequence parallelism), and are not copied."""
    from ldm_tf2_tpu_torch.ops.cross_attention import kernel_takes

    return (_PACKED_CROSS_ENABLED and _ATTENTION_IMPL != "xla"
            and kernel_takes(q_len, kv_len, size_per_head))


def attention(q, k, v, scale: float):
    """The JAX package's ``dot_product_attention`` dispatch for the
    attentions that are not spatial self-attention (the text encoder's, the
    U-Net's cross-attention): the flash kernel under ``attention_impl``
    "flash", where the JAX package's ``_use_flash`` is always true, else
    ``dot_product_attention`` (under "auto" the JAX package takes its kernel
    only at 1024 or more tokens, which these never have)."""
    if _ATTENTION_IMPL == "flash":
        from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale)
    return dot_product_attention(q, k, v, scale)


def dot_product_attention(q, k, v, scale: float):
    """Scaled dot-product attention, [B,Q,H,S] x [B,C,H,S] -> [B,Q,H,S]."""
    logits = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqc,bchs->bqhs", weights, v)
