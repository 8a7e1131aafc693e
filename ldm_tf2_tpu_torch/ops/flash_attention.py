"""Flash-attention forward: CUDA kernel for CUDA tensors, plain PyTorch for
CPU tensors.

Counterpart of ``ldm_tf2_tpu.ops.flash_attention.flash_attention``.  The
kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``_flash_kernel``; it reads the unpadded ``[B, T, H, S]`` layout directly
(no 128-lane head padding, no head-major relayout).
"""

from __future__ import annotations

import ctypes

import torch

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.attention import dot_product_attention

MAX_HEAD_DIM = 512
_DTYPES = (torch.float32, torch.bfloat16)


def _plain(q, k, v, scale):
    """The plain version: the same function in plain PyTorch."""
    return dot_product_attention(q, k, v, scale)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, S], got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(
                f"q, k, v must share one dtype of {_DTYPES}, got "
                f"{q.dtype}, {k.dtype}, {v.dtype}"
            )
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    b, _, h, s = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, s):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if k.shape[1] < 1:
        raise ValueError("attention needs at least one key")


def _launch(q, k, v, scale):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got {q.device}")
    s = q.shape[-1]
    if s > MAX_HEAD_DIM:
        raise ValueError(f"head dim {s} exceeds the kernel's {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _build.load("flash_attention")
    fn = lib.ldm_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    b, tq, h, _ = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, tq, k.shape[1], h, s, float(scale),
        int(q.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v over [B, T, H, S] tensors (bf16 or f32).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``flash_attention.launches`` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _plain(q, k, v, scale)
    return _launch(q, k, v, scale)


flash_attention.launches = 0
