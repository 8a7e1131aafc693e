"""Short-kv attention: the whole key sequence in one tile.

Counterpart of ``ldm_tf2_tpu.ops.cross_attention.cross_attention_flat``.  A
CUDA tensor runs the kernel ``csrc/cross_attention.cu`` (which replaces the
TPU kernel ``_cross_kernel``); a CPU tensor runs ``_plain_cross_attention``,
the kernel's formula in plain PyTorch:

    s = (q k^T in float32) * scale;  p = exp(s - max(s));  l = sum(p)
    w = (p / l) cast to v's dtype  (before the P V product)
    o = w v, accumulated in float32, cast to v's dtype

The port reads its unpadded [B, T, H, S] layout, not the JAX package's
128-lane packed one.  The U-Net's 77-token cross-attentions take it under
``ops.attention.set_packed_cross(True)`` wherever ``kernel_takes`` accepts
the shape; the gate decides speed only (the plain route,
``ops.attention.dot_product_attention``, is the same function up to
rounding).  Differentiable: the backward recomputes through
``dot_product_attention``, as the JAX ``custom_vjp`` recomputes through
``_xla_reference_flat``.

On the card, bf16 at the U-Net's head dims (40, 80, 160) with at most 80
keys takes the kernel's wgmma path (``cross_plan``): K and V loaded once
per CTA, 64-query tiles through a TMA ring; other bf16 shapes its mma.sync
path, float32 its FMA path.  ``cross_attention.launches_by_path`` counts
launches by path.
"""

from __future__ import annotations

import ctypes

import torch

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.attention import dot_product_attention
from ldm_tf2_tpu_torch.ops.flash_attention import PATHS, SMS

MAX_KV = 128    # the key tile (the JAX package's MAX_KV_PAD // 4)
MAX_HEAD = 160  # the U-Net's widest head
_DTYPES = (torch.float32, torch.bfloat16)

# The wgmma path (``csrc/cross_attention.cu``): head dims it is built for,
# its key tile (TMA zero-fills keys past Tk), query rows per tile, and Q
# ring stages per consumer warpgroup.
CROSS_WGMMA_HEADS = (40, 80, 160)
CROSS_KEYS = 80
CROSS_ROWS = 64
CROSS_STAGES = 2


def cross_plan(b: int, tq: int, tk: int, h: int, s: int, dtype) -> dict:
    """The kernel's path for q [b, tq, h, s] and kv [b, tk, h, s], and the
    wgmma path's geometry: a CTA per (b, head) and group of ``per_cta``
    consecutive 64-query tiles, as many groups as bring the grid near one
    wave of ``SMS`` CTAs; two consumer warpgroups (alternate tiles) where a CTA
    has two tiles or more, else one.  K and V (``CROSS_KEYS`` rows of
    ``chunks`` 64-column chunks each) load once per CTA, Q tiles through
    ``CROSS_STAGES`` stages per warpgroup.  Shared memory: 1024 bytes to
    align, K, V, the Q ring, 128 bytes of barriers."""
    if dtype != torch.bfloat16:
        return {"path": "fma"}
    if s not in CROSS_WGMMA_HEADS or tk > CROSS_KEYS:
        return {"path": "mma.sync" if s % 8 == 0 else "fma"}
    tiles = -(-tq // CROSS_ROWS)
    per_cta = -(-tiles // min(tiles, max(1, -(-SMS // (b * h)))))
    nwg = 2 if per_cta >= 2 else 1
    chunks = -(-(-(-s // 16) * 16) // 64)
    kv_bytes = chunks * CROSS_KEYS * 128
    q_bytes = chunks * CROSS_ROWS * 128
    stages = CROSS_STAGES * nwg
    return dict(path="wgmma", ksteps=-(-s // 16), chunks=chunks, per_cta=per_cta,
                warpgroups=nwg, stages=stages, kv_bytes=kv_bytes, q_bytes=q_bytes,
                smem_bytes=1024 + 2 * kv_bytes + stages * q_bytes + 128,
                threads=128 * nwg + 32, grid=(-(-tiles // per_cta), b * h))


def geometry_arg(plan: dict):
    """The C entry's geometry argument for a wgmma plan: {query rows, keys,
    stages, shared bytes, per_cta, consumer warpgroups}."""
    return _build.int_array((CROSS_ROWS, CROSS_KEYS, plan["stages"], plan["smem_bytes"],
                             plan["per_cta"], plan["warpgroups"]))


def kernel_takes(q_len: int, kv_len: int, size_per_head: int) -> bool:
    """Whether the kernel takes a shape: the whole kv sequence fits its one
    tile and the head fits its shared memory.  Any query length."""
    return q_len >= 1 and 1 <= kv_len <= MAX_KV and 1 <= size_per_head <= MAX_HEAD


def _plain_cross_attention(q, k, v, scale: float):
    """The kernel's formula on [B, Q, H, S] x [B, C, H, S]."""
    s = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqc,bchs->bqhs", w.float(), v.float())
    return out.to(v.dtype)


def _launch(q, k, v, scale):
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention takes CPU or CUDA tensors, got {q.device}")
    b, tq, h, s = q.shape
    tk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    plan = cross_plan(b, tq, tk, h, s, q.dtype)
    geometry = geometry_arg(plan) if plan["path"] == "wgmma" else None
    fn = _build.entry("cross_attention", "ldm_cross_attention", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    out = torch.empty_like(q)
    path = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, tk, h,
             s, float(scale), int(q.dtype == torch.bfloat16), geometry, ctypes.byref(path),
             torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(err, "cross_attention kernel launch")
    cross_attention.launches += 1
    cross_attention.launches_by_path[PATHS[2 - path.value]] += 1
    return out


class _CrossAttention(torch.autograd.Function):
    """The kernel forward (plain on CPU tensors); the backward recomputes
    through ``dot_product_attention`` and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return _plain_cross_attention(q, k, v, scale)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        args = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = dot_product_attention(*args, ctx.scale)
        return (*torch.autograd.grad(out, args, grad), None)


def cross_attention(q, k, v, scale: float):
    """Attention of q [B, Q, H, S] to a short k, v [B, C, H, S] (C <= 128):
    the single-tile kernel on the card, its plain version on the CPU.
    ``cross_attention.launches`` counts kernel launches,
    ``launches_by_path`` them by path ("wgmma", "mma.sync", "fma")."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, T, H, S], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {_DTYPES}")
    b, tq, h, s = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, s):
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if not kernel_takes(tq, k.shape[1], s):
        raise ValueError(f"the cross-attention kernel takes kv <= {MAX_KV} and "
                         f"S <= {MAX_HEAD}, got kv {k.shape[1]}, S {s}")
    if _build.needs_grad(q, k, v):
        return _CrossAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return _plain_cross_attention(q, k, v, scale)
    return _launch(q, k, v, scale)


cross_attention.launches = 0
cross_attention.launches_by_path = dict.fromkeys(PATHS, 0)
