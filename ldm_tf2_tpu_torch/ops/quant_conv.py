"""W8A8 int8 ResBlock chain for serving: GN -> SiLU -> quantize -> s8 3x3
conv -> dequantize (+bias, +time, +residual).

Counterpart of ``ldm_tf2_tpu.ops.quant_conv`` (the serving mode
``tpu.quantize: int8``).  Two kernels carry it on the card:

* ``csrc/gn_silu_quant.cu`` (``gn_silu_quant``) replaces the TPU kernels
  ``_gn_silu_quant_kernel`` and ``_gn_silu_quant_stream_kernel``: f32 group
  statistics (fast variance), normalize, affine, SiLU, per-image scale
  ``sa = max(amax, 1e-8) / 127`` and ``y8 = clip(round(y * (1 / sa)))``.
* ``csrc/s8_conv3x3.cu`` (``s8_conv3x3``) replaces ``_batched_conv_kernel``:
  the s8 x s8 -> s32 3x3 SAME conv with the epilogue
  ``acc * (sa[b] * ws[co]) + b (+t) (+residual)`` in f32, cast to the
  activation dtype.  Launched after the first, it is also the card's form
  of the TPU's whole-chain ``_chain_kernel``.

Weights are quantized once per output channel (``quantize_weight``) when
the mode is switched on: they are frozen at inference.  The s8 kernel reads
them as ``[Cout, 3, 3, Cin]`` so that each output channel's 9 * Cin values
are contiguous, tap-major.

Dispatch semantics: which convs are quantized changes the images, not only
the speed, so the JAX package's shape gate (``use_int8_conv``,
``use_fused_int8_chain``, ``_chain_pick`` and their TPU VMEM models) is
copied here verbatim as pure functions of shape.  The kernels choose their
own tiling.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)

# ------------------------------------------------------------------ gate --
# Copied from ldm_tf2_tpu/ops/quant_conv.py:367-375, 378-408, 527-592.


def _vmem_bytes(hw: int, c: int) -> int:
    pc = (c + 127) // 128 * 128
    return hw * pc * (2 * 2 + 4 + 4 + 1 * 2)


_VMEM_BUDGET = int(12.5 * 1024 * 1024)


def _chain_vmem_bytes(hw: int, w: int, cin: int, blk: int, n_blk: int,
                      rc: int, has_add: bool) -> int:
    pad = lambda c: (c + 127) // 128 * 128
    slab = (hw + 2 * (w + 1)) * pad(cin)
    xs = hw * pad(cin) * (2 * 2 + 4 + 4)
    xs += rc * pad(cin) * 4
    weights = 9 * pad(cin) * pad(blk) * (2 if n_blk > 1 else 1)
    accs = hw * pad(blk) * (4 + 2 * 2)
    if has_add:
        accs += hw * pad(blk) * 2 * 2
    return slab + xs + weights + accs


_CHAIN_VMEM_BUDGET = int(15.5 * 1024 * 1024)


def _chain_pick(hw, w, cin, cout, has_add):
    blk_cands = [cout] + [
        m * 128 for m in (8, 4, 2, 1)
        if m * 128 < cout and cout % (m * 128) == 0
    ]
    rc_cands = [hw] + [
        r for r in (512, 256, 128)
        if r < hw and hw % r == 0 and hw // r <= 4
    ]
    for rc in rc_cands:
        for blk in blk_cands:
            if _chain_vmem_bytes(hw, w, cin, blk, cout // blk, rc,
                                 has_add) <= _CHAIN_VMEM_BUDGET:
                return blk, rc
    return None


def use_fused_int8_chain(hw, w, cin, cout, has_add) -> bool:
    return hw >= 256 and _chain_pick(hw, w, cin, cout, has_add) is not None


def use_int8_conv(shape, cout: int | None = None, num_groups: int = 32,
                  has_add: bool = False) -> bool:
    """Whether the int8 mode quantizes a chain of input ``shape`` [B, H, W,
    Cin] and ``cout`` outputs: hw == 64 (8x8), or hw >= 256 where the JAX
    package's whole-chain kernel claims.  Everything else stays in the
    activation dtype.  The caller checks that the mode is on."""
    _, h, w, c = shape
    if c % num_groups != 0:
        return False
    hw = h * w
    if hw == 64:
        return _vmem_bytes(hw, c) <= _VMEM_BUDGET
    if cout is None:
        return False
    return use_fused_int8_chain(hw, w, c, cout, has_add)


# --------------------------------------------------------------- weights --

def quantize_weight(w):
    """Per-output-channel symmetric s8 quantization of an OIHW kernel, from
    the weights as stored, cast to float32: ``ws = max(max|w|, 1e-12) / 127``,
    ``w8 = clip(round(w / ws), -127, 127)``.  Returns (w8 OIHW int8, ws
    [Cout] float32)."""
    wf = w.float()
    ws = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(wf / ws[:, None, None, None]), -127, 127)
    return w8.to(torch.int8), ws


def int8_conv_weights(w):
    """(w8 [Cout, 3, 3, Cin] int8, ws [Cout] float32): ``quantize_weight``
    in the layout the s8 conv reads."""
    w8, ws = quantize_weight(w)
    return w8.permute(0, 2, 3, 1).contiguous(), ws


# ------------------------------------------------------ GN+SiLU+quantize --

def _plain_gn_silu_quant(x, gamma, beta, num_groups, eps):
    """The JAX kernel's math: float32 sums per channel over HW, then per
    group; fast variance; normalize, affine, SiLU; per-image scale; codes
    by multiplying with the scale's reciprocal, rounding half to even."""
    b, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(b, h * w, c)
    n = float(h * w * cg)
    mean = xf.sum(dim=1).reshape(b, num_groups, cg).sum(dim=-1) / n
    ex2 = (xf * xf).sum(dim=1).reshape(b, num_groups, cg).sum(dim=-1) / n
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xf = xf.reshape(b, h * w, num_groups, cg)
    scale = rstd[:, None, :, None] * gamma.float().reshape(num_groups, cg)
    y = (xf - mean[:, None, :, None]) * scale
    y = y + beta.float().reshape(num_groups, cg)
    y = y * torch.sigmoid(y)
    sa = torch.clamp(y.abs().amax(dim=(1, 2, 3)), min=1e-8) * (1.0 / 127.0)
    y8 = torch.clamp(torch.round(y * (1.0 / sa)[:, None, None, None]),
                     -127.0, 127.0)
    return y8.to(torch.int8).reshape(b, h, w, c), sa


def _launch_gn_silu_quant(x, gamma, beta, num_groups, eps):
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_quant takes CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    b, h, w, c = x.shape
    lib = _build.load("gn_silu_quant")
    fn = lib.ldm_gn_silu_quant
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    y8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sa = torch.empty(b, dtype=torch.float32, device=x.device)
    stats = torch.empty(b * num_groups * 2, dtype=torch.float32, device=x.device)
    amax = torch.empty(b, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y8.data_ptr(),
        sa.data_ptr(), stats.data_ptr(), amax.data_ptr(), b, h * w, c,
        num_groups, float(eps), int(x.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "gn_silu_quant kernel launch")
    gn_silu_quant.launches += 1
    return y8, sa


def gn_silu_quant(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm + SiLU + per-image symmetric int8 quantization of NHWC
    ``x``.  Returns (y8 [B, H, W, C] int8, sa [B] float32) with
    ``y8 * sa[b] ~= silu(group_norm(x))``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``gn_silu_quant.launches`` counts kernel launches."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    if x.device.type == "cpu":
        return _plain_gn_silu_quant(x, gamma, beta, num_groups, eps)
    return _launch_gn_silu_quant(x, gamma, beta, num_groups, eps)


gn_silu_quant.launches = 0


# ------------------------------------------------------------ s8 3x3 conv --

def _plain_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                      out_dtype):
    """Exact integer conv (float64 holds every s32 sum exactly), then the
    f32 epilogue in the JAX package's order."""
    acc = F.conv2d(y8.permute(0, 3, 1, 2).double(),
                   w8.permute(0, 3, 1, 2).double(), padding=1)
    acc = torch.round(acc).permute(0, 2, 3, 1).float()
    out = acc * (sa.float()[:, None, None, None] * ws.float())
    out = out + bias.float()
    if time_add is not None:
        out = out + time_add.float()[:, None, None, :]
    if residual_add is not None:
        out = out + residual_add.float()
    return out.to(out_dtype)


def _launch_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                       out_dtype):
    if y8.device.type != "cuda":
        raise ValueError(f"s8_conv3x3 takes CPU or CUDA tensors, got {y8.device}")
    b, h, w, cin = y8.shape
    cout = w8.shape[0]
    if cin % 32 != 0:
        raise ValueError(f"the s8 conv kernel needs Cin % 32 == 0, got {cin}")
    f32 = dict(device=y8.device, dtype=torch.float32)
    sa, ws, bias = (t.to(**f32).contiguous() for t in (sa, ws, bias))
    for name, t in (("time_add", time_add), ("residual_add", residual_add)):
        if t is not None and t.dtype != out_dtype:
            raise TypeError(f"{name} is {t.dtype}, the output {out_dtype}")
    y8, w8 = y8.contiguous(), w8.contiguous()
    if y8.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("the s8 conv kernel reads y8 and w8 in 16-byte rows: "
                         "both must start 16-byte aligned")
    extras = [None if t is None else t.contiguous()
              for t in (time_add, residual_add)]
    lib = _build.load("s8_conv3x3")
    fn = lib.ldm_s8_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=y8.device)
    stream = torch.cuda.current_stream(y8.device).cuda_stream
    err = fn(
        y8.data_ptr(), sa.data_ptr(), w8.data_ptr(), ws.data_ptr(),
        bias.data_ptr(), *(None if t is None else t.data_ptr() for t in extras),
        out.data_ptr(), b, h, w, cin, cout,
        int(out_dtype == torch.bfloat16), stream,
    )
    _build.check(err, "s8_conv3x3 kernel launch")
    s8_conv3x3.launches += 1
    return out


def s8_conv3x3(y8, sa, w8, ws, bias, *, time_add=None, residual_add=None,
               out_dtype=torch.float32):
    """3x3 SAME s8 conv of y8 [B, H, W, Cin] (int8, per-image scale sa [B])
    with w8 [Cout, 3, 3, Cin] (int8, per-channel scale ws [Cout]), then
    ``acc * (sa[b] * ws[co]) + bias`` (+ time_add [B, Cout]) (+ residual_add
    [B, H, W, Cout]) in float32, cast to ``out_dtype``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``s8_conv3x3.launches`` counts kernel launches."""
    if y8.dim() != 4 or y8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError("y8 must be [B, H, W, Cin] int8 and w8 int8")
    b, h, w, cin = y8.shape
    cout = w8.shape[0]
    if tuple(w8.shape) != (cout, 3, 3, cin):
        raise ValueError(f"w8 has shape {tuple(w8.shape)}, want ({cout}, 3, 3, {cin})")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be one of {_DTYPES}, got {out_dtype}")
    want = {"sa": (sa, (b,)), "ws": (ws, (cout,)), "bias": (bias, (cout,))}
    if time_add is not None:
        want["time_add"] = (time_add, (b, cout))
    if residual_add is not None:
        want["residual_add"] = (residual_add, (b, h, w, cout))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.device != y8.device:
            raise ValueError(f"{name} is on {t.device}, y8 on {y8.device}")
    if y8.device.type == "cpu":
        return _plain_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                                 out_dtype)
    return _launch_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                              out_dtype)


s8_conv3x3.launches = 0


def gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, b, *, time_add=None,
                         residual_add=None, num_groups: int = 32,
                         eps: float = 1e-5):
    """The int8 twin of ``ops.fused_conv.gn_silu_conv3x3``: ``gn_silu_quant``
    then ``s8_conv3x3`` (two launches on the card), output in x's dtype.
    w8, ws: ``int8_conv_weights`` of the conv kernel."""
    y8, sa = gn_silu_quant(x, gamma, beta, num_groups, eps)
    return s8_conv3x3(y8, sa, w8, ws, b, time_add=time_add,
                      residual_add=residual_add, out_dtype=x.dtype)
