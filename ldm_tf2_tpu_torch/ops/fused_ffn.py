"""Fused transformer FFN: LN -> GEGLU -> Dense -> +residual.

Counterpart of ``ldm_tf2_tpu.ops.fused_ffn.fused_ffn``.  A CUDA tensor runs
the kernel ``csrc/fused_ffn.cu`` (which replaces the TPU kernel
``_ffn_kernel``); a CPU tensor runs ``_plain_ffn``, the JAX package's
``_xla_ffn`` in plain PyTorch.

    y   = LayerNorm(x; ln_scale, ln_bias, eps)     f32 stats, fast variance
    u   = (y @ w1v + b1v) * gelu_exact(y @ w1g + b1g)
    out = u @ w2 + b2 + x

Weights keep the JAX layouts: w1v, w1g [d, 4d] (in x out), w2 [4d, d].

``fused_ffn_int8`` is the W8A8 variant (the TPU kernel ``_ffn_kernel_int8``,
``csrc/fused_ffn_int8.cu`` on the card, ``_plain_ffn_int8`` on the CPU).
As in the JAX package it is a building block that no path dispatches:
``fused_ffn`` never takes it, whatever the int8 serving modes say.

Differentiation is the JAX package's ``_fused_bwd`` design: when an input
needs a gradient, ``fused_ffn`` runs as a ``torch.autograd.Function``
whose forward is the kernel (the plain version on CPU tensors) and whose
backward recomputes the chain through ``_plain_ffn`` and differentiates
that.  The JAX package has no Pallas FFN backward: its recompute is plain
matmuls that XLA runs outside any kernel, so the port's stays plain
PyTorch too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.quant_conv import quantize_activations, quantize_cols

MAX_WIDTH = 1280
_DTYPES = (torch.float32, torch.bfloat16)


def _plain_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps=1e-5):
    """The plain version (``_xla_ffn``): fast variance E[x^2]-E[x]^2 clamped
    at 0, f32 statistics, LN output cast to the activation dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(x.dtype)
    a = y @ w1v + b1v
    g = y @ w1g + b1g
    u = a * F.gelu(g)
    return u @ w2 + b2 + x


def _check(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, d], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    d = x.shape[-1]
    f = w1v.shape[-1] if w1v.dim() == 2 else -1
    want = {
        "ln_scale": (ln_scale, (d,)), "ln_bias": (ln_bias, (d,)),
        "w1v": (w1v, (d, f)), "b1v": (b1v, (f,)),
        "w1g": (w1g, (d, f)), "b1g": (b1g, (f,)),
        "w2": (w2, (f, d)), "b2": (b2, (d,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn takes CPU or CUDA tensors, got {x.device}")
    b, t, d = x.shape
    f = w1v.shape[1]
    if d > MAX_WIDTH:
        raise ValueError(f"width {d} exceeds the kernel's {MAX_WIDTH}")
    for name, w in (("w1v", w1v), ("b1v", b1v), ("w1g", w1g), ("b1g", b1g),
                    ("w2", w2), ("b2", b2)):
        if w.dtype != x.dtype:
            raise TypeError(f"{name} is {w.dtype}, x is {x.dtype}")
    for name, a in (("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias),
                    ("w1v", w1v), ("b1v", b1v), ("w1g", w1g), ("b1g", b1g),
                    ("w2", w2), ("b2", b2)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ln_scale.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise TypeError("ln_scale and ln_bias must be float32")
    lib = _build.load("fused_ffn")
    size = lib.ldm_fused_ffn_workspace_floats
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    fn = lib.ldm_fused_ffn_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    # f32 partial sums when the kernel splits the hidden width over blocks
    workspace = torch.empty(size(b * t, d, f), dtype=torch.float32,
                            device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1v.data_ptr(), b1v.data_ptr(), w1g.data_ptr(), b1g.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        workspace.data_ptr() if workspace.numel() else None,
        b * t, d, f, float(eps), int(x.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "fused_ffn kernel launch")
    fused_ffn.launches += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """The kernel forward (plain on CPU tensors); the backward recomputes
    through ``_plain_ffn`` and differentiates it."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps):
        args = (x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2)
        ctx.save_for_backward(*args)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _plain_ffn(*args, eps)
        return _launch(*args, eps)

    @staticmethod
    def backward(ctx, grad):
        args = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _plain_ffn(*args, ctx.eps)
        return (*torch.autograd.grad(out, args, grad), None)


def fused_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps=1e-5):
    """LN -> GEGLU -> Dense -> +residual over [B, T, d].

    x: [B, T, d] bf16 or f32; ln_scale, ln_bias: [d] (f32 on the card);
    w1v, w1g: [d, F]; b1v, b1g: [F]; w2: [F, d]; b2: [d], all in x's dtype
    on the card.  A CPU tensor takes the plain version; a CUDA tensor takes
    the kernel, or raises.  Differentiable on both (see the module
    docstring).  ``fused_ffn.launches`` counts kernel launches."""
    _check(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2)
    if _build.needs_grad(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2):
        return _FusedFFN.apply(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2,
                               b2, eps)
    if x.device.type == "cpu":
        return _plain_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps)
    return _launch(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps)


fused_ffn.launches = 0


# ------------------------------------------------------------ W8A8 FFN --
# Copied as definitions from ldm_tf2_tpu/ops/fused_ffn.py: the polynomial
# GELU (``_GELU_POLY_CS``, ``_gelu_poly_f32``) and ``_ffn_kernel_int8``'s
# arithmetic.  Its per-column weight quantization (``_quant_cols``) and its
# per-row activation codes are the int8 conv's rules, ``quant_conv``'s
# ``quantize_cols`` and ``quantize_activations``.

# Degree-9 fit of x * erf(x / sqrt(2)) in t = x^2 on |x| <= 4, highest power
# last; gelu(x) = 0.5 x + 0.5 h(x), h := |x| beyond 4.
GELU_POLY_CS = (
    1.17001125700400e-05, 7.97724482796235e-01, -1.32617207955768e-01,
    1.96232925549133e-02, -2.22546161701489e-03, 1.90177605018239e-04,
    -1.17833702310525e-05, 4.93687027647959e-07, -1.23685744320984e-08,
    1.38723939155963e-10,
)


class Int8FFNWeights(NamedTuple):
    """The FFN's kernels quantized per output column, stored transposed
    (each column's K values contiguous): w1v8, w1g8 [F, d] and w28 [d, F]
    int8, with float32 scales s1v, s1g [F] and s2 [d]."""

    w1v8: torch.Tensor
    s1v: torch.Tensor
    w1g8: torch.Tensor
    s1g: torch.Tensor
    w28: torch.Tensor
    s2: torch.Tensor


def gelu_poly(x):
    """The JAX package's polynomial GELU in float32 (``_gelu_poly_f32``),
    within 2.3e-5 of the exact one on |x| <= 4."""
    ax = x.abs()
    t = torch.square(torch.clamp(ax, max=4.0))
    p = torch.full_like(x, GELU_POLY_CS[-1])
    for c in GELU_POLY_CS[-2::-1]:
        p = p * t + c
    h = torch.where(ax > 4.0, ax, p)
    return 0.5 * x + 0.5 * h


def quantize_ffn_weights(w1v, w1g, w2) -> Int8FFNWeights:
    """Quantize the FFN's three kernels (JAX layouts w1v, w1g [d, F], w2
    [F, d]) once, for every later ``fused_ffn_int8`` call."""
    (w1v8, s1v), (w1g8, s1g), (w28, s2) = (quantize_cols(w) for w in (w1v, w1g, w2))
    return Int8FFNWeights(w1v8.T.contiguous(), s1v, w1g8.T.contiguous(), s1g,
                          w28.T.contiguous(), s2)


def _s8_product(codes, w8t):
    """i32(codes . w8t^T) as float32: codes [M, K] (integral floats), w8t
    [N, K] int8; float64 holds every sum exactly, and the cast to float32
    rounds it as the kernel's s32 -> f32 conversion does."""
    return (codes.double() @ w8t.double().T).float()


def _plain_ffn_int8(x, ln_scale, ln_bias, q: Int8FFNWeights, b1v, b1g, b2,
                    eps=1e-5):
    """The plain version: ``_ffn_kernel_int8``'s arithmetic with its one
    j-block (the JAX wrapper's ``_pick_tiles`` always takes the whole hidden
    row of 4d), in float32 with the products exact."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d).float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * ln_scale.float() + ln_bias.float()
    y8, sy = quantize_activations(y, -1)
    a = _s8_product(y8, q.w1v8) * (sy * q.s1v) + b1v.float()
    g = _s8_product(y8, q.w1g8) * (sy * q.s1g) + b1g.float()
    u8, su = quantize_activations(a * gelu_poly(g), -1)
    acc = _s8_product(u8, q.w28) * (su * q.s2)
    out = acc.to(x.dtype) + b2.to(x.dtype) + x.reshape(b * t, d)
    return out.reshape(b, t, d)


def _launch_int8(x, ln_scale, ln_bias, q: Int8FFNWeights, b1v, b1g, b2, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_int8 takes CPU or CUDA tensors, got {x.device}")
    b, t, d = x.shape
    f = q.w1v8.shape[0]
    m = b * t
    if d % 32 or f % 32 or d > MAX_WIDTH:
        raise ValueError(f"the int8 FFN kernel needs d % 32 == 0, d <= {MAX_WIDTH} "
                         f"and F % 32 == 0, got d {d}, F {f}")
    if b2.dtype != x.dtype:
        raise TypeError(f"b2 is {b2.dtype}, x is {x.dtype}")
    for name, w in zip(q._fields, q):
        want = torch.int8 if name.startswith("w") else torch.float32
        if w.dtype != want:
            raise TypeError(f"{name} is {w.dtype}, want {want}")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    x = x.contiguous()
    f32 = [a.to(device=x.device, dtype=torch.float32).contiguous()
           for a in (ln_scale, ln_bias, b1v, b1g)]
    lib = _build.load("fused_ffn_int8")
    fn = lib.ldm_fused_ffn_int8
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    y8 = torch.empty((m, d), dtype=torch.int8, device=x.device)
    u = torch.empty((m, f), dtype=torch.float32, device=x.device)
    sy, su = (torch.empty(m, dtype=torch.float32, device=x.device) for _ in range(2))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
        q.w1v8.data_ptr(), q.s1v.data_ptr(), f32[2].data_ptr(),
        q.w1g8.data_ptr(), q.s1g.data_ptr(), f32[3].data_ptr(),
        q.w28.data_ptr(), q.s2.data_ptr(), b2.contiguous().data_ptr(),
        out.data_ptr(), y8.data_ptr(), sy.data_ptr(), u.data_ptr(), su.data_ptr(),
        m, d, f, float(eps), int(x.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "fused_ffn_int8 kernel launch")
    fused_ffn_int8.launches += 1
    return out


def fused_ffn_int8(x, ln_scale, ln_bias, q: Int8FFNWeights, b1v, b1g, b2,
                   eps=1e-5):
    """W8A8 LN -> GEGLU -> dense -> +x over [B, T, d] (any B * T), the
    weights from ``quantize_ffn_weights``: per-row dynamic activation
    scales, per-column weight scales, s8 products, the polynomial GELU.
    x and b2 bf16 or float32; ln_scale, ln_bias, b1v, b1g are applied in
    float32.  A CPU tensor takes the plain version; a CUDA tensor takes the
    kernel, or raises.  A sampling-only building block, as in the JAX
    package: it refuses differentiation and no path dispatches it.
    ``fused_ffn_int8.launches`` counts kernel launches."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be [B, T, d] in {_DTYPES}, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    f = q.w1v8.shape[0]
    want = {"ln_scale": (ln_scale, (d,)), "ln_bias": (ln_bias, (d,)),
            "b1v": (b1v, (f,)), "b1g": (b1g, (f,)), "b2": (b2, (d,)),
            "w1v8": (q.w1v8, (f, d)), "w1g8": (q.w1g8, (f, d)), "w28": (q.w28, (d, f)),
            "s1v": (q.s1v, (f,)), "s1g": (q.s1g, (f,)), "s2": (q.s2, (d,))}
    for name, (tensor, shape) in want.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, want {shape}")
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
    _build.refuse_grad("the int8 FFN", x, ln_scale, ln_bias, b1v, b1g, b2)
    if x.device.type == "cpu":
        return _plain_ffn_int8(x, ln_scale, ln_bias, q, b1v, b1g, b2, eps)
    return _launch_int8(x, ln_scale, ln_bias, q, b1v, b1g, b2, eps)


fused_ffn_int8.launches = 0
