"""Fused transformer FFN: LN -> GEGLU -> Dense -> +residual.

Counterpart of ``ldm_tf2_tpu.ops.fused_ffn.fused_ffn``.  A CUDA tensor runs
the kernel ``csrc/fused_ffn.cu`` (which replaces the TPU kernel
``_ffn_kernel``); a CPU tensor runs ``_plain_ffn``, the JAX package's
``_xla_ffn`` in plain PyTorch.

    y   = LayerNorm(x; ln_scale, ln_bias, eps)     f32 stats, fast variance
    u   = (y @ w1v + b1v) * gelu_exact(y @ w1g + b1g)
    out = u @ w2 + b2 + x

Weights keep the JAX layouts: w1v, w1g [d, 4d] (in x out), w2 [4d, d].

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

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build

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
