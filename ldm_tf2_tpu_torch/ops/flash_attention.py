"""Flash-attention forward: CUDA kernels for CUDA tensors, plain PyTorch for
CPU tensors.

Counterpart of ``ldm_tf2_tpu.ops.flash_attention.flash_attention``.  The
kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``_flash_kernel``; it reads the unpadded ``[B, T, H, S]`` layout directly
(no 128-lane head padding, no head-major relayout).

``flash_attention_pv_int8`` is the serving mode
``tpu.quantize_attention: int8pv``: the TPU kernel with ``pv_int8=True``
(``csrc/flash_attention_pv_int8.cu``).  Its results depend on the TPU
kernel's kv block (v is quantized per block, p against the running max up
to the block), so that block size, ``jax_block_k``, is copied from the JAX
package as a definition of the function, not as a tuning choice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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


def _check_launch(q, k, v, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {q.shape[-1]} exceeds the kernel's {MAX_HEAD_DIM}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k, v, scale):
    _check_launch(q, k, v, "flash_attention")
    s = q.shape[-1]
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


# ------------------------------------------------------------- int8 P.V --

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def jax_block_k(s: int, kv_len: int) -> int:
    """The kv block of the JAX package's flash forward for head dim ``s``:
    ``min(_pick_blocks(lane_pad(s), kv_len)[1], round_up(kv_len, 128))``
    (``ldm_tf2_tpu/ops/flash_attention.py:92-119, 234-237``).  The int8-PV
    mode quantizes v per such block and p against the running max up to
    it, so the block is part of the function's definition."""
    sp = _round_up(s, _LANE)
    blocks = ((1024, 1024), (1024, 512), (512, 512), (512, 256),
              (256, 256), (256, 128), (128, 128))
    if kv_len >= 2048:
        blocks = ((1024, 2048),) + blocks
    bk = 128
    for bq, cand in blocks:
        if (bq + 2 * cand) * sp * 8 <= 9 * 1024 * 1024:
            bk = cand
            break
    return min(bk, _round_up(kv_len, _LANE))


def _plain_pv_int8(q, k, v, scale):
    """The plain version of ``_flash_kernel`` with ``pv_int8=True``: per
    JAX kv block, the running row max m, p = exp(s - m) quantized to
    p8 = round(127 p), l summing p8 / 127, v quantized per (b, h, block),
    and the block's integer p8 . v8 (exact, in float64) scaled by sv / 127
    before it is folded into the accumulator."""
    b, tq, h, s = q.shape
    tk = k.shape[1]
    bk = jax_block_k(s, tk)
    nblk = -(-tk // bk)
    pad = nblk * bk - tk
    qf = q.float().permute(0, 2, 1, 3) * scale
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    m = torch.full((b, h, tq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, tq, 1), device=q.device)
    acc = torch.zeros((b, h, tq, s), device=q.device)
    for j in range(nblk):
        kb, vb = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
        logits = qf @ kb.transpose(-1, -2)
        if pad and j == nblk - 1:
            logits[..., bk - pad:] = -1e30
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p8 = torch.round(torch.exp(logits - m_new) * 127.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + (p8 * (1.0 / 127.0)).sum(dim=-1, keepdim=True)
        sv = torch.clamp(vb.abs().amax(dim=(2, 3), keepdim=True),
                         min=1e-8) * (1.0 / 127.0)
        v8 = torch.clamp(torch.round(vb * (1.0 / sv)), -127.0, 127.0)
        pv = (p8.double() @ v8.double()).float() * (sv * (1.0 / 127.0))
        acc = acc * alpha + pv
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def _launch_pv_int8(q, k, v, scale):
    _check_launch(q, k, v, "flash_attention_pv_int8")
    b, tq, h, s = q.shape
    tk = k.shape[1]
    bk = jax_block_k(s, tk)
    lib = _build.load("flash_attention_pv_int8")
    fn = lib.ldm_flash_attention_pv_int8_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    sv = torch.empty(b * h * -(-tk // bk), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        sv.data_ptr(), b, tq, tk, h, s, float(scale), bk,
        int(q.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "flash_attention_pv_int8 kernel launch")
    flash_attention_pv_int8.launches += 1
    return out


def flash_attention_pv_int8(q, k, v, scale: float):
    """``flash_attention`` with the P.V product in int8 (the serving mode
    ``tpu.quantize_attention: int8pv``), over [B, T, H, S] tensors.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``flash_attention_pv_int8.launches`` counts kernel
    launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _plain_pv_int8(q, k, v, scale)
    return _launch_pv_int8(q, k, v, scale)


flash_attention_pv_int8.launches = 0


# The JAX package runs int8 P.V only inside its flash kernel, which it takes
# for q and kv of 1024 or more tokens (ldm_tf2_tpu/ops/attention.py
# _use_flash).  Copied because it decides which attentions are quantized,
# and so the images; the bf16 kernel takes every other self-attention.
PV_INT8_MIN_TOKENS = 1024


def spatial_self_attention(q, k, v, scale: float, pv_int8: bool = False):
    """The models' spatial self-attention: ``flash_attention_pv_int8`` when
    the int8-P.V serving mode is on and q and kv have at least
    ``PV_INT8_MIN_TOKENS`` tokens, else ``flash_attention``."""
    if pv_int8 and min(q.shape[1], k.shape[1]) >= PV_INT8_MIN_TOKENS:
        return flash_attention_pv_int8(q, k, v, scale)
    return flash_attention(q, k, v, scale)
