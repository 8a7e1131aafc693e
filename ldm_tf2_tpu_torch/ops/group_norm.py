"""GroupNorm(+SiLU) over channels-last tensors, with the JAX package's
opt-in kernels.

Counterpart of ``ldm_tf2_tpu.ops.group_norm``.  The switch
``set_groupnorm_impl`` keeps the JAX names and values:

* ``"auto"`` (the default): ``_mxu_group_norm``, plain PyTorch with the
  semantics of the JAX default ``_mxu_stats_group_norm``: per-group sums of
  x and x^2 in float32, variance E[x^2]-E[x]^2 clamped at 0, normalize,
  affine and optional SiLU in float32, result in the input dtype.
* ``"xla"``: ``_xla_group_norm``, the two-pass reference
  (``jnp.mean(square(x - mean))``).
* ``"pallas"``: ``group_norm_fused``, the kernel ``csrc/group_norm.cu``
  that replaces the TPU's ``_gn_kernel``: stats, normalize, affine
  ``(x - mean) * (rstd * gamma) + beta`` and SiLU, variance NOT clamped,
  in one launch on thread-block clusters that read x once
  (``csrc/gn_cluster.cuh``, geometry from ``quant_conv.gn_cluster_plan``).
* ``"stats"``: ``group_stats`` (the same source's stats kernel, replacing
  ``_gn_stats_kernel``: per-channel mean and rstd = rsqrt(E[x^2] - mean^2
  + eps), unclamped) followed by the normalize in PyTorch, as the JAX
  package's ``_stats_hybrid_group_norm``.

``"mxu"``, ``"barrier"`` and ``"dotstats"`` are XLA fusion experiments of
the JAX package with no meaning here: they raise ``ValueError``.  The
switch reaches the ``GroupNorm`` modules and the ResBlock's split training
chain, as in the JAX package; the GN+SiLU+conv chains compute their own
statistics (``ops.fused_conv``), which this switch does not move.

Dispatch semantics: under "pallas" or "stats" the kernels take every shape
``kernel_takes`` accepts, and a shape it refuses takes ``_xla_group_norm``,
the JAX package's own fallback.  The kernels compute the same function as
the plain routes up to rounding, so the gate decides speed, not results.

On the card the kernels run as ``torch.autograd.Function``s whose backward
recomputes through ``_xla_group_norm``, as the JAX ``custom_vjp`` does.  A
CPU tensor takes the kernels' plain versions (``_plain_group_norm_fused``,
``_plain_group_stats``); a CUDA tensor takes the kernel, or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.quant_conv import (
    GN_PATHS, check_clusters, gn_cluster_plan, gn_geometry,
)

_DTYPES = (torch.float32, torch.bfloat16)
_IMPLS = ("auto", "xla", "pallas", "stats")
_XLA_ONLY = ("mxu", "barrier", "dotstats")
_IMPL = "auto"


def set_groupnorm_impl(impl: str) -> None:
    """``"auto"`` | ``"xla"`` | ``"pallas"`` | ``"stats"`` (see the module
    docstring)."""
    global _IMPL
    if impl in _XLA_ONLY:
        raise ValueError(
            f"groupnorm impl {impl!r} is an XLA fusion experiment of the JAX "
            f"package with no counterpart here; use one of {_IMPLS}"
        )
    if impl not in _IMPLS:
        raise ValueError(f"unknown groupnorm impl: {impl!r}")
    _IMPL = impl


def get_groupnorm_impl() -> str:
    return _IMPL


def kernel_takes(shape, num_groups: int = 32) -> bool:
    """Whether the GroupNorm kernels take an input of ``shape`` [B, ...,
    C]: a batch, at least one spatial position and whole groups.  Both
    kernels take any number of positions: the stats kernel streams them,
    the fused kernel keeps what its clusters' shared memory holds and reads
    the rest again."""
    return (len(shape) >= 3 and shape[-1] % num_groups == 0
            and all(s > 0 for s in shape))


# ------------------------------------------------------------ plain math --

def _group_sums(x, num_groups: int):
    """float32 per-channel sums of x and x^2 over the positions, then per
    group: ([B, G], [B, G], n), n the elements in a group."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    cg = c // num_groups
    s1 = xf.sum(dim=1).reshape(b, num_groups, cg).sum(dim=-1)
    s2 = (xf * xf).sum(dim=1).reshape(b, num_groups, cg).sum(dim=-1)
    return s1, s2, float(xf.shape[1] * cg)


def _fast_stats(x, num_groups: int, eps: float, clamp: bool):
    """Per-channel (mean, rstd) [B, C] float32 from the fast variance
    E[x^2] - mean^2, clamped at 0 when ``clamp``."""
    s1, s2, n = _group_sums(x, num_groups)
    mean = s1 / n
    var = s2 / n - mean * mean
    if clamp:
        var = torch.clamp(var, min=0.0)
    rstd = torch.rsqrt(var + eps)
    cg = x.shape[-1] // num_groups
    return (mean.repeat_interleave(cg, dim=-1),
            rstd.repeat_interleave(cg, dim=-1))


def _normalize(x, mean, rstd, gamma, beta, activate: bool):
    """``(x - mean) * (rstd * gamma) + beta`` (+ SiLU) in float32, per
    channel statistics [B, C], result in x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    y = (x.float() - mean.reshape(shape)) * (
        rstd.reshape(shape) * gamma.float()) + beta.float()
    if activate:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _mxu_group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                    activate: bool = False):
    """The "auto" route (``_mxu_stats_group_norm``): float32 sums over each
    group at once, clamped fast variance, normalize, affine, SiLU."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, num_groups, cg)
    n = float(xf.shape[1] * cg)
    mean = xf.sum(dim=(1, 3)) / n  # [B, G]
    var = torch.clamp((xf * xf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd[:, None, :, None] * gamma.float().reshape(num_groups, cg)
    y = (xf - mean[:, None, :, None]) * scale + beta.float().reshape(num_groups, cg)
    if activate:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _xla_group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                    activate: bool = False):
    """The "xla" route and the kernels' backward: two-pass variance."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.float() + beta.float()
    if activate:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _plain_group_stats(x, num_groups: int, eps: float):
    """Row 6's plain version: per-channel (mean, rstd) [B, C] float32,
    rstd = rsqrt(E[x^2] - mean^2 + eps), not clamped."""
    return _fast_stats(x, num_groups, eps, clamp=False)


def _plain_group_norm_fused(x, gamma, beta, num_groups: int, eps: float,
                            activate: bool):
    """Row 5's plain version: the unclamped fast variance, then
    ``(x - mean) * (rstd * gamma) + beta`` and the optional SiLU."""
    mean, rstd = _plain_group_stats(x, num_groups, eps)
    return _normalize(x, mean, rstd, gamma, beta, activate)


# --------------------------------------------------------------- kernels --

def _check(x, gamma, beta, num_groups):
    if x.dim() < 3:
        raise ValueError(f"x must be [B, ..., C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            continue
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _f32(t, device):
    return t.to(device=device, dtype=torch.float32).contiguous()


# The stats kernel's grid fills the card's 132 SMs about twice
STATS_CTAS = 264


def stats_vec(x) -> int:
    """Elements per load of the stats kernel (``csrc/gn_stats.cuh``): 16
    bytes along C where C and x's base allow it, else one."""
    per = 16 // x.element_size()
    return per if x.shape[-1] % per == 0 and x.data_ptr() % 16 == 0 else 1


def stats_grid(b: int, hw: int, c: int, num_groups: int, vec: int):
    """(chunks, gps): how the stats kernel splits each image's positions
    into chunks and its channels into slices of ``gps`` whole groups (a
    multiple of ``vec`` channels), for about ``STATS_CTAS`` blocks of at
    least 32 positions: grid (chunks, ceil(num_groups / gps), b).  A
    function of the shape only, so the summation order is fixed per
    shape."""
    cg = c // num_groups
    chunks = max(1, min(-(-STATS_CTAS // b), hw // 32))
    unit = vec // math.gcd(cg, vec)  # groups per slice step: unit * cg % vec == 0
    want = -(-STATS_CTAS // (b * chunks))
    gps = min(max(unit, num_groups // want // unit * unit), 256 // unit * unit)
    return chunks, gps


_WORKSPACES: dict = {}


def stats_workspace(device, b: int, chunks: int, gps: int, num_groups: int):
    """(partial, tickets) pointers for a stats launch (rows 6 and 7's
    statistics, ``csrc/gn_stats.cuh``): a float32 area for the
    chunks' group sums and one counter per (image, slice), kept per device
    between calls (the counters start at 0 and the kernel's last block of
    each (image, slice) sets its counter back to 0).  A grid of one chunk
    needs neither."""
    if chunks == 1:
        return None, None
    slices = -(-num_groups // gps)
    n_partial = b * slices * chunks * gps * 2
    n_tickets = b * slices
    key = device.index if device.index is not None else torch.cuda.current_device()
    partial, tickets = _WORKSPACES.get(key, (None, None))
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(max(n_partial, 1 << 16), dtype=torch.float32, device=device)
        _STATS_ARGS.clear()  # their pointers may be to the old workspace
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1 << 10), dtype=torch.int32, device=device)
        _STATS_ARGS.clear()
    _WORKSPACES[key] = (partial, tickets)
    return partial.data_ptr(), tickets.data_ptr()


_STATS_ARGS: dict = {}


def stats_args(x, num_groups):
    """The stats launch's (hw, chunks, gps, vec, partial, tickets) for a
    contiguous CUDA ``x`` [B, ..., C], kept per shape (the wrappers run
    once per GroupNorm, and their host time is paid before the kernel
    starts)."""
    key = (x.shape, x.dtype, x.get_device(), x.data_ptr() % 16 == 0, num_groups)
    args = _STATS_ARGS.get(key)
    if args is None:
        b, c = x.shape[0], x.shape[-1]
        hw = x.numel() // (b * c)
        vec = stats_vec(x)
        chunks, gps = stats_grid(b, hw, c, num_groups, vec)
        ws = stats_workspace(x.device, b, chunks, gps, num_groups)
        args = _STATS_ARGS[key] = (hw, chunks, gps, vec, *ws)
    return args


def _launch_stats(x, num_groups, eps):
    if not x.is_cuda:
        raise ValueError(f"group_stats takes CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    b, c = x.shape[0], x.shape[-1]
    hw, chunks, gps, vec, partial, tickets = stats_args(x, num_groups)
    fn = _build.entry("group_norm", "ldm_group_stats", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)  # mean, rstd
    err = fn(x.data_ptr(), out.data_ptr(), partial, tickets, b, hw, c, num_groups, chunks,
             gps, vec, float(eps), x.dtype == torch.bfloat16,
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "group_stats kernel launch")
    group_stats.launches += 1
    return out.unbind(0)


_FUSED_PLANS: dict = {}


def fused_plan(x, num_groups: int) -> dict:
    """Row 5's ``gn_cluster_plan`` (a cluster per image and slice of whole
    groups) for a CUDA ``x``, checked against the card once per shape,
    dtype and device."""
    key = (x.shape, x.dtype, x.get_device(), num_groups)
    plan = _FUSED_PLANS.get(key)
    if plan is None:
        plan = gn_cluster_plan(tuple(x.shape), x.dtype, False, num_groups)
        check_clusters("group_norm", "ldm_group_norm_clusters", plan, x.shape, x.dtype,
                       x.shape[0], num_groups)
        plan = _FUSED_PLANS[key] = dict(plan, geometry=gn_geometry(plan))
    return plan


def _launch_fused(x, gamma, beta, num_groups, eps, activate):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fused takes CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    b, c = x.shape[0], x.shape[-1]
    plan = fused_plan(x, num_groups)
    if plan["vec"] > 1 and x.data_ptr() % 16:  # a view into a row: 16-byte loads need a copy
        x = x.clone()
    gamma, beta = _f32(gamma, x.device), _f32(beta, x.device)
    fn = _build.entry("group_norm", "ldm_group_norm", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b,
             x.numel() // (b * c), c, num_groups, float(eps), int(activate),
             int(x.dtype == torch.bfloat16), plan["geometry"],
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "group_norm kernel launch")
    group_norm_fused.launches += 1
    group_norm_fused.launches_by_path[plan["mode"]] += 1
    return out


class _GroupNormFused(torch.autograd.Function):
    """Row 5's kernel (its plain version on CPU tensors); the backward
    recomputes through ``_xla_group_norm`` and differentiates it."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, activate):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, activate)
        if x.device.type == "cpu":
            return _plain_group_norm_fused(x, gamma, beta, num_groups, eps, activate)
        return _launch_fused(x, gamma, beta, num_groups, eps, activate)

    @staticmethod
    def backward(ctx, grad):
        return _recompute_grads(ctx, grad, _xla_group_norm) + (None, None, None)


class _StatsGroupNorm(torch.autograd.Function):
    """Row 6's kernel, then the normalize in PyTorch; the backward
    recomputes through ``_xla_group_norm``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, activate):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, activate)
        return _stats_group_norm(x, gamma, beta, num_groups, eps, activate)

    @staticmethod
    def backward(ctx, grad):
        return _recompute_grads(ctx, grad, _xla_group_norm) + (None, None, None)


def _recompute_grads(ctx, grad, reference):
    args = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
    with torch.enable_grad():
        out = reference(*args, *ctx.args)
    return tuple(torch.autograd.grad(out, args, grad))


def _stats_group_norm(x, gamma, beta, num_groups, eps, activate):
    mean, rstd = group_stats(x, num_groups, eps)
    return _normalize(x, mean, rstd, gamma, beta, activate)


def group_stats(x, num_groups: int = 32, eps: float = 1e-5):
    """Per-channel GroupNorm statistics of [B, ..., C] ``x``: (mean, rstd),
    each [B, C] float32, rstd = rsqrt(E[x^2] - mean^2 + eps) (not clamped).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``group_stats.launches`` counts kernel calls."""
    _check(x, None, None, num_groups)
    if x.is_cpu:
        return _plain_group_stats(x, num_groups, eps)
    return _launch_stats(x, num_groups, eps)


group_stats.launches = 0


def group_norm_fused(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                     activate: bool = False):
    """GroupNorm (+ SiLU) of [B, ..., C] ``x`` in one kernel call: the
    unclamped fast variance, ``(x - mean) * (rstd * gamma) + beta``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises: one launch on thread-block clusters (``fused_plan``).
    Differentiable on both.  ``group_norm_fused.launches`` counts kernel
    calls, ``launches_by_path`` them by the plan's mode ("resident" or
    "reread")."""
    _check(x, gamma, beta, num_groups)
    if _build.needs_grad(x, gamma, beta):
        return _GroupNormFused.apply(x, gamma, beta, num_groups, eps, activate)
    if x.device.type == "cpu":
        return _plain_group_norm_fused(x, gamma, beta, num_groups, eps, activate)
    return _launch_fused(x, gamma, beta, num_groups, eps, activate)


group_norm_fused.launches = 0
group_norm_fused.launches_by_path = dict.fromkeys(GN_PATHS, 0)


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
               activate: bool = False):
    """GroupNorm over [B, spatial..., C] with optional fused SiLU, by the
    route ``set_groupnorm_impl`` selects."""
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if _IMPL in ("pallas", "stats"):
        if not kernel_takes(tuple(x.shape), num_groups):
            return _xla_group_norm(x, gamma, beta, num_groups, eps, activate)
        if _IMPL == "pallas":
            return group_norm_fused(x, gamma, beta, num_groups, eps, activate)
        if _build.needs_grad(x, gamma, beta):
            return _StatsGroupNorm.apply(x, gamma, beta, num_groups, eps, activate)
        return _stats_group_norm(x, gamma, beta, num_groups, eps, activate)
    if _IMPL == "xla":
        return _xla_group_norm(x, gamma, beta, num_groups, eps, activate)
    return _mxu_group_norm(x, gamma, beta, num_groups, eps, activate)
