"""The ResBlock chain GN -> SiLU -> 3x3 SAME conv -> +bias, +time, +residual.

Counterpart of ``ldm_tf2_tpu.ops.fused_conv.gn_silu_conv3x3``.  The switch
``set_fused_conv_impl`` keeps the JAX names and values:

* ``"auto"`` (the default) and ``"xla"``: the JAX package's ``_xla_ref``
  with its conv emitter, here GroupNorm (``_mxu_group_norm``) and
  ``F.conv2d`` (cuDNN on the card).
* ``"pallas"``: ``gn_silu_conv3x3_fused``, the kernel
  ``csrc/gn_silu_conv3x3.cu`` that replaces the TPU's whole-chain
  ``_kernel``, wherever ``kernel_takes`` accepts the shape; anything else
  stays on the "auto" route.

``"dots"`` and ``"dots3"`` work around XLA's convolution emitter on the TPU
and have no meaning here: they raise ``ValueError``.  In the int8 serving
mode the chains the JAX package's gate claims take the W8A8 route of
``ops.quant_conv`` first, whatever this switch says, as in the JAX package.

The chain computes its own GroupNorm statistics, with the clamped fast
variance (``_mxu_stats_group_norm`` in the JAX package, which
``set_groupnorm_impl`` does not reach), on every route.  Dispatch
semantics: the fused kernel and the "auto" route compute the same function
up to rounding, so ``kernel_takes`` decides speed, not results.

Activations are NHWC.  Convolution kernels are in PyTorch's OIHW order
(the checkpoint bridge transposes the JAX package's HWIO kernels once, at
load time).  The fused kernel's wgmma path (``conv_plan``: bf16 with Cin %
64 == 0, every chain the models run in bf16) reads them relaid as ``[9,
Cout, Cin]`` (``relaid_weight``: once per weight and version, cached); its
other paths read OIHW in place.  An NHWC tensor permuted to NCHW is a
channels-last NCHW view, so no activation is copied on either side of the
cuDNN convolution.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.flash_attention import PATHS
from ldm_tf2_tpu_torch.ops.group_norm import _mxu_group_norm, stats_args
from ldm_tf2_tpu_torch.ops.quant_conv import (
    conv_tiles, geometry_arg, gn_silu_conv3x3_int8, use_int8_conv,
)

_DTYPES = (torch.float32, torch.bfloat16)
_IMPLS = ("auto", "xla", "pallas")
_XLA_ONLY = ("dots", "dots3")
_IMPL = "auto"

def set_fused_conv_impl(impl: str) -> None:
    """``"auto"`` | ``"xla"`` | ``"pallas"`` (see the module docstring)."""
    global _IMPL
    if impl in _XLA_ONLY:
        raise ValueError(
            f"fused_conv impl {impl!r} works around XLA's TPU conv emitter and "
            f"has no counterpart here; use one of {_IMPLS}"
        )
    if impl not in _IMPLS:
        raise ValueError(f"unknown fused_conv impl: {impl!r}")
    _IMPL = impl


def get_fused_conv_impl() -> str:
    return _IMPL


def kernel_takes(shape, cout: int, num_groups: int = 32) -> bool:
    """Whether the fused chain kernel takes an input of ``shape`` [B, H, W,
    Cin] and ``cout`` outputs: whole groups.  It streams any H, W (nothing
    has to fit on chip); bf16 inputs with Cin % 32 == 0 run on the tensor
    cores, the rest on FMAs."""
    b, h, w, cin = shape
    return min(b, h, w, cin, cout) > 0 and cin % num_groups == 0


def conv_splits(m: int, cin: int, cout: int) -> int:
    """How many blocks the tensor-core conv splits each 64 x 64 output tile's
    K = 9 * Cin over (``csrc/gn_silu_conv3x3.cu``): 1 where the tiles alone
    fill the card twice over, else enough to reach that, each split at
    least one 32-channel block.  A function of the shape only, so the
    summation order is fixed per shape."""
    tiles = -(-m // 64) * -(-cout // 64)
    blocks = cin // 32
    if cin % 32 or tiles >= 264 or blocks < 2:
        return 1
    per_split = -(-blocks // min(blocks, -(-264 // tiles)))
    return -(-blocks // per_split)


def conv_plan(shape, cout: int, dtype) -> dict:
    """The conv path of the fused chain for an input of ``shape`` [B, H, W,
    Cin] and ``cout`` outputs, and the wgmma path's launch geometry.

    float32 takes the FMA path (the JAX kernel's float32 products are exact;
    TF32 would change results).  bf16 with Cin % 64 == 0 and Cout % 8 == 0
    takes wgmma; other bf16 shapes the mma.sync path (Cin % 32 == 0; the C
    side also needs 16-byte aligned operands) or FMA.  The geometry is
    ``quant_conv.conv_tiles`` with 64-channel k-steps and two sub-tiles a
    warpgroup up to M = 256 (one tile covers every pixel, so each weight
    byte is read once a call); each split writes float32 sums."""
    cin = shape[-1]
    if dtype != torch.bfloat16:
        return {"path": "fma"}
    if cin % 64 or cout % 8:
        return {"path": "mma.sync" if cin % 32 == 0 else "fma"}
    return conv_tiles(shape, cout, 64, 256)


# id(weight) -> (weakref to it, dtype, its _version, the relaid copy)
_RELAID: dict = {}
# Inside ``relayout_inside``: every call relays, past the cache
_INSIDE = [False]


@contextlib.contextmanager
def relayout_inside():
    """Every ``relaid_weight`` call inside the block relays its weight and
    leaves the cache alone: a captured train step, whose replays update the
    weights in place, must relay them in every replay (its eager warm-up
    has filled the cache with the weights before its own update)."""
    _INSIDE[0] = True
    try:
        yield
    finally:
        _INSIDE[0] = False


def relaid_weight(w, dtype):
    """``w`` [Cout, Cin, 3, 3] in ``dtype``, relaid as ``[9, Cout, Cin]``
    (tap-major, Cin contiguous): the wgmma conv's K-major B operand, which
    TMA can read (OIHW strides Cin by 9 elements).  Cached per weight
    tensor, dtype and ``_version``: an in-place update (an optimizer step)
    relays again, and the copy is freed with the weight.  Counts
    ``gn_silu_conv3x3_fused.relayouts``."""
    key = id(w)
    hit = None if _INSIDE[0] else _RELAID.get(key)
    if hit is not None and hit[0]() is w and hit[1] == dtype and hit[2] == w._version:
        return hit[3]
    cout, cin = w.shape[:2]
    copy = w.detach().to(dtype).permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()
    gn_silu_conv3x3_fused.relayouts += 1
    if _INSIDE[0]:
        return copy
    if hit is None or hit[0]() is not w:
        weakref.finalize(w, _RELAID.pop, key, None)
    _RELAID[key] = (weakref.ref(w), dtype, w._version, copy)
    return copy


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0):
    """NHWC convolution with an OIHW kernel; weights cast to x's dtype."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype),
        None if b is None else b.to(x.dtype), stride=stride, padding=padding,
    )
    return out.permute(0, 2, 3, 1)


def conv3x3(y, w, b):
    """3x3 SAME convolution (stride 1) of NHWC ``y`` with OIHW ``w``."""
    return conv2d(y, w, b, padding=1)


def _plain_chain(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps):
    """Row 7's plain version, in the TPU kernel's order: clamped-variance
    GroupNorm and SiLU in float32, cast to x's dtype; the conv of x-dtype
    values accumulated in float32; then, in x's dtype, ``acc + b``,
    ``+ time_add``, ``+ residual_add``.  Also the backward's recompute (the
    JAX package's ``_xla_ref`` with the 9-dots conv)."""
    dt = x.dtype
    y = _mxu_group_norm(x, gamma, beta, num_groups, eps, activate=True)
    acc = F.conv2d(y.permute(0, 3, 1, 2).float(), w.to(dt).float(), padding=1)
    out = acc.permute(0, 2, 3, 1).to(dt) + b.to(dt)
    if time_add is not None:
        out = out + time_add[:, None, None, :].to(dt)
    if residual_add is not None:
        out = out + residual_add.to(dt)
    return out


def _launch(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps):
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3_fused takes CPU or CUDA tensors, got {x.device}")
    dt = x.dtype
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    plan = conv_plan(tuple(x.shape), cout, dt)
    f32 = dict(device=x.device, dtype=torch.float32)
    gamma, beta = gamma.to(**f32).contiguous(), beta.to(**f32).contiguous()
    x, b = x.contiguous(), b.to(dt).contiguous()
    extras = [None if t is None else t.to(dt).contiguous()
              for t in (time_add, residual_add)]
    _, chunks, gps, vec, partial, tickets = stats_args(x, num_groups)
    if plan["path"] == "wgmma":
        geometry = geometry_arg(plan)
        wr, w, splits = relaid_weight(w, dt), None, plan["splits"]
    else:
        geometry, wr, w = None, None, w.to(dt).contiguous()
        splits = conv_splits(bsz * h * wd, cin, cout) if dt == torch.bfloat16 else 1
    # per-channel mean and rstd * gamma (rounded up to 16 bytes), then the
    # split-K partial sums
    stats = -(-2 * bsz * cin // 4) * 4
    scratch = torch.empty(stats + (splits * bsz * h * wd * cout if splits > 1 else 0), **f32)
    y = torch.empty_like(x)  # the normalized input
    out = torch.empty((bsz, h, wd, cout), dtype=dt, device=x.device)
    path = ctypes.c_int(-1)
    fn = _build.entry("gn_silu_conv3x3", "ldm_gn_silu_conv3x3", [ctypes.c_void_p] * 13 + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             None if w is None else w.data_ptr(), None if wr is None else wr.data_ptr(),
             b.data_ptr(), *(None if t is None else t.data_ptr() for t in extras),
             out.data_ptr(), y.data_ptr(), scratch.data_ptr(), partial, tickets, bsz, h, wd,
             cin, cout, num_groups, chunks, gps, vec, splits, float(eps),
             int(dt == torch.bfloat16), geometry, ctypes.byref(path),
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "gn_silu_conv3x3 kernel launch")
    gn_silu_conv3x3_fused.launches += 1
    gn_silu_conv3x3_fused.launches_by_path[PATHS[2 - path.value]] += 1
    return out


def _chain(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps):
    if x.device.type == "cpu":
        return _plain_chain(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps)
    return _launch(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps)


class _FusedChain(torch.autograd.Function):
    """The kernel forward (plain on CPU tensors); the backward recomputes
    through ``_plain_chain`` and differentiates it."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, time_add, residual_add, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta, w, b, time_add, residual_add)
        ctx.args = (num_groups, eps)
        return _chain(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        args = [None if t is None else t.detach().requires_grad_(True) for t in saved]
        with torch.enable_grad():
            out = _plain_chain(*args, *ctx.args)
        live = [t for t in args if t is not None]
        grads = iter(torch.autograd.grad(out, live, grad))
        return (*(None if t is None else next(grads) for t in args), None, None)


def gn_silu_conv3x3_fused(x, gamma, beta, w, b, *, time_add=None, residual_add=None,
                          num_groups: int = 32, eps: float = 1e-5):
    """The whole chain in one kernel call (see ``gn_silu_conv3x3``).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  Differentiable on both.  ``gn_silu_conv3x3_fused.launches``
    counts kernel calls, ``launches_by_path`` them by conv path ("wgmma",
    "mma.sync", "fma"), ``relayouts`` the wgmma path's weight relayouts."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"x must be [B, H, W, Cin] in one of {_DTYPES}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    want = {"gamma": (gamma, (cin,)), "beta": (beta, (cin,)), "w": (w, (cout, cin, 3, 3)),
            "b": (b, (cout,))}
    if time_add is not None:
        want["time_add"] = (time_add, (bsz, cout))
    if residual_add is not None:
        want["residual_add"] = (residual_add, (bsz, h, wd, cout))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not kernel_takes(tuple(x.shape), cout, num_groups):
        raise ValueError(f"the fused chain kernel does not take {tuple(x.shape)} -> {cout} "
                         f"with {num_groups} groups")
    if _build.needs_grad(x, gamma, beta, w, b, time_add, residual_add):
        return _FusedChain.apply(x, gamma, beta, w, b, time_add, residual_add,
                                 num_groups, eps)
    return _chain(x, gamma, beta, w, b, time_add, residual_add, num_groups, eps)


gn_silu_conv3x3_fused.launches = 0
gn_silu_conv3x3_fused.launches_by_path = dict.fromkeys(PATHS, 0)
gn_silu_conv3x3_fused.relayouts = 0


def gn_silu_conv3x3(x, gamma, beta, w, b, *, time_add=None, residual_add=None,
                    num_groups: int = 32, eps: float = 1e-5,
                    int8_weights=None):
    """GroupNorm -> SiLU -> 3x3 SAME conv (+bias, +optional epilogues).

    x: [B, H, W, Cin]; gamma, beta: [Cin]; w: [Cout, Cin, 3, 3]; b: [Cout];
    time_add: optional [B, Cout]; residual_add: optional [B, H, W, Cout].
    int8_weights: ``quant_conv.int8_conv_weights(w)`` when the int8 serving
    mode is on for the caller (the U-Net's ResBlocks; the autoencoder's
    never pass them, as the JAX package's never opt in), else None.  The
    chain then takes the W8A8 route where the JAX package's shape gate
    ``use_int8_conv`` claims it; otherwise the route the switch selects.
    """
    if int8_weights is not None and use_int8_conv(
        x.shape, w.shape[0], num_groups, has_add=residual_add is not None,
    ):
        w8, ws = int8_weights
        return gn_silu_conv3x3_int8(
            x, gamma, beta, w8, ws, b, time_add=time_add,
            residual_add=residual_add, num_groups=num_groups, eps=eps,
        )
    if _IMPL == "pallas" and kernel_takes(tuple(x.shape), w.shape[0], num_groups):
        return gn_silu_conv3x3_fused(
            x, gamma, beta, w, b, time_add=time_add, residual_add=residual_add,
            num_groups=num_groups, eps=eps,
        )
    y = _mxu_group_norm(x, gamma, beta, num_groups, eps, activate=True)
    out = conv3x3(y, w, b)
    if time_add is not None:
        out = out + time_add[:, None, None, :].to(out.dtype)
    if residual_add is not None:
        out = out + residual_add.to(out.dtype)
    return out
