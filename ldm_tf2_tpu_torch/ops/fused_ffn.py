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
from ldm_tf2_tpu_torch.ops.flash_attention import PATHS, SMS
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


# The wgmma path's instantiations (``csrc/fused_ffn.cu``): the
# up-projection's consumer warpgroups -> ring stages, and the
# down-projection's (consumer warpgroups, N tile) -> ring stages, as many as
# the shared memory holds, at most 8.  An up stage is one A tile (the row
# tile x 64 features of y) and a hidden block's 64 x 64 B chunks of w1v and
# of w1g; a down stage one A tile (the row tile x 64 hidden columns of u)
# and the N tile's 64 x 64 chunks of w2; 128-byte rows.
FFN_UP_STAGES = {1: 8, 2: 7}
FFN_DOWN_STAGES = {(1, 128): 8, (2, 128): 7, (1, 160): 7, (2, 160): 5}
FFN_MIN_SPLIT_STEPS = 4  # hidden k-steps of 64 a down-projection split takes at least


def ffn_plan(m: int, d: int, f: int, dtype) -> dict:
    """The FFN's path for ``m`` rows of width ``d`` and hidden width ``f``,
    and the wgmma path's launch geometry.

    float32 takes the FMA path.  bf16 with d a multiple of 64 and of 128 or
    160, at most ``MAX_WIDTH``, and F a multiple of 128 takes wgmma (the C
    side also needs 16-byte aligned operands; every FFN of the models);
    other bf16 shapes the FMA path.  The wgmma path is three launches (four
    with a split):

    * the LayerNorm, y = LN(x) in bf16, one warp per row;
    * the up-projection u = (y w1v + b1v) * gelu(y w1g + b1g) in bf16: a
      CTA owns a row tile of ``bm`` rows (64 where m <= 64, else 128) and
      ``up_per`` hidden blocks of 64 columns, as many as keep row tiles x
      groups within one wave of ``SMS``; every weight byte is read by each
      row tile once.  With 128 rows, two consumer warpgroups (``warpgroups``)
      take alternate blocks and turns at the tensor cores;
    * the down-projection out = u w2 + b2 + x: N tiles of ``bn`` columns
      (128, or 160 where 128 does not divide d), the F / 64 hidden k-steps
      split where the tiles cannot fill the card (as for the convs: each
      split at least ``FFN_MIN_SPLIT_STEPS`` k-steps, its float32 sums in
      its own slot, a last pass adding them in split order and applying the
      epilogue);
    * shared memory: 1024 bytes to align, the stages, 16 bytes of barriers
      a stage."""
    if dtype != torch.bfloat16:
        return {"path": "fma"}
    if d % 64 or f % 128 or (d % 128 and d % 160) or d > MAX_WIDTH:
        return {"path": "fma"}
    nwg = 1 if m <= 64 else 2
    bm = 64 * nwg
    row_tiles = -(-m // bm)
    blocks = k_steps = f // 64
    per = -(-blocks // max(1, min(blocks, SMS // row_tiles)))
    up_stages = FFN_UP_STAGES[nwg]
    bn = 128 if d % 128 == 0 else 160
    tiles_n = d // bn
    splits = max(1, min(SMS // (row_tiles * tiles_n), k_steps // FFN_MIN_SPLIT_STEPS))
    per_split = -(-k_steps // splits)
    splits = -(-k_steps // per_split)
    down_stages = FFN_DOWN_STAGES[(nwg, bn)]
    chunks = -(-bn // 64)
    return dict(path="wgmma", warpgroups=nwg, bm=bm, row_tiles=row_tiles, hidden_blocks=blocks,
                up_per=per, up_grid=(row_tiles, -(-blocks // per)), up_stages=up_stages,
                up_smem=1024 + up_stages * (bm * 128 + 2 * 64 * 128 + 16), bn=bn,
                down_grid=(row_tiles, tiles_n, splits), splits=splits, per_split=per_split,
                down_stages=down_stages,
                down_smem=1024 + down_stages * (bm * 128 + chunks * 64 * 128 + 16))


def geometry_arg(plan: dict):
    """The C entry's geometry argument for a wgmma plan: {up warpgroups, up
    stages, hidden blocks per up CTA, down warpgroups, down N tile, down
    stages, down k-steps per split, up shared bytes, down shared bytes}."""
    return _build.int_array((plan["warpgroups"], plan["up_stages"], plan["up_per"],
                             plan["warpgroups"], plan["bn"], plan["down_stages"],
                             plan["per_split"], plan["up_smem"], plan["down_smem"]))


def _launch(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn takes CPU or CUDA tensors, got {x.device}")
    b, t, d = x.shape
    f = w1v.shape[1]
    m = b * t
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
    if d > MAX_WIDTH:
        raise ValueError(f"width {d} exceeds the kernel's {MAX_WIDTH}")
    plan = ffn_plan(m, d, f, x.dtype)
    fn = _build.entry("fused_ffn", "ldm_fused_ffn_fwd", [ctypes.c_void_p] * 13 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    out = torch.empty_like(x)
    geometry = y = u = workspace = None
    if plan["path"] == "wgmma":
        geometry = geometry_arg(plan)
        y = torch.empty((m, d), dtype=x.dtype, device=x.device)  # the LayerNorm
        u = torch.empty((m, f), dtype=x.dtype, device=x.device)  # the GEGLU hidden
        if plan["splits"] > 1:  # the down-projection's split sums
            workspace = torch.empty((plan["splits"], m, d), dtype=torch.float32,
                                    device=x.device)
    else:
        # f32 partial sums when the kernel splits the hidden width over blocks
        size = _build.entry("fused_ffn", "ldm_fused_ffn_workspace_floats", [ctypes.c_int] * 3)
        size.restype = ctypes.c_longlong
        floats = size(m, d, f)
        if floats:
            workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
    path = ctypes.c_int(-1)
    err = fn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1v.data_ptr(), b1v.data_ptr(), w1g.data_ptr(), b1g.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        *(None if a is None else a.data_ptr() for a in (workspace, y, u)),
        m, d, f, float(eps), int(x.dtype == torch.bfloat16), geometry, ctypes.byref(path),
        torch._C._cuda_getCurrentRawStream(x.get_device()),
    )
    _build.check(err, "fused_ffn kernel launch")
    fused_ffn.launches += 1
    fused_ffn.launches_by_path[PATHS[2 - path.value]] += 1
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
    docstring).  ``fused_ffn.launches`` counts kernel calls,
    ``launches_by_path`` them by path ("wgmma", "fma"; ``ffn_plan``
    chooses)."""
    _check(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2)
    if _build.needs_grad(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2):
        return _FusedFFN.apply(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2,
                               b2, eps)
    if x.device.type == "cpu":
        return _plain_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps)
    return _launch(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps)


fused_ffn.launches = 0
fused_ffn.launches_by_path = dict.fromkeys(PATHS, 0)


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


# The W8A8 kernel's geometry (``csrc/fused_ffn_int8.cu``): a cluster of
# ``cluster`` CTAs owns a tile of FFN8_BM rows; a ring slot holds one
# up-projection stage (value and gate boxes of 64 hidden rows x 128 k) or one
# down-projection stage (FFN8_BN output rows x 128 k).
FFN8_BM = 64
FFN8_HB = 64  # hidden columns per up-projection tile
FFN8_BN = 80  # output columns per down-projection tile
FFN8_SLOT = 16384
# sy, two partial row maxima, the published maxima, su; 12 down slots' barriers
FFN8_SMALL = 5 * FFN8_BM * 4 + 16 * 12
FFN8_MAX_SMEM = 232448  # 227 KB, the most a CTA may have
FFN8_MAX_STAGES = 6
FFN8_CLUSTERS = (1, 2, 4, 8, 16)  # 16 is non-portable: only where 8 does not fit
FFN8_MIN_CTAS = 64  # the smallest cluster that gives the grid half the card's SMs

def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def _ffn8_layout(d: int, f: int, cluster: int, resident: bool) -> dict:
    """The shared-memory layout of one CTA: 1024 bytes to align, ``stages``
    ring slots (an even number, half for each warpgroup), y8 (64 rows of d
    codes in chunks of 128; with the ring, the down-projection's slots
    later), the u region (f32 u where ``resident``, and the warpgroups' s32
    exchange of a down tile), ``FFN8_SMALL`` bytes of row scales and
    maxima, 16 bytes of barriers a stage."""
    tiles = -(-f // FFN8_HB)
    tpr = -(-tiles // cluster)
    y_bytes = FFN8_BM * _align(d, 128)
    u_bytes = _align(max(tpr * FFN8_BM * FFN8_HB * 4 if resident else 0,
                         FFN8_BM * FFN8_BN * 4), 1024)
    fixed = 1024 + y_bytes + u_bytes + FFN8_SMALL
    stages = min(FFN8_MAX_STAGES, (FFN8_MAX_SMEM - fixed) // (FFN8_SLOT + 16))
    stages -= stages % 2  # half the slots serve each warpgroup
    return dict(cluster=cluster, tpr=tpr, stages=stages, resident=resident,
                y_bytes=y_bytes, u_bytes=u_bytes,
                smem=fixed + stages * (FFN8_SLOT + 16))


def ffn8_plan(m: int, d: int, f: int, dtype=torch.bfloat16) -> dict:
    """The W8A8 FFN's launch geometry for ``m`` rows of width ``d`` and
    hidden width ``f`` (``dtype``, bf16 or float32, changes nothing: both
    run s8 products).  One launch on a grid of ``cluster`` x ``row_tiles``
    CTAs in clusters of ``cluster``:

    * ``row_tiles`` tiles of 64 rows, one per cluster;
    * ``tiles`` hidden tiles of 64 columns (the last ragged where F % 64 ==
      32), ``tpr`` a rank: rank r owns tiles [r tpr, (r + 1) tpr);
    * ``out_tiles`` down-projection tiles of 80 output columns (the last
      ragged), tile i finished by rank i % cluster, over ``k_chunks`` K
      chunks of 128 hidden columns taken by the two warpgroups in turn;
    * ``cluster``: among the portable sizes (1-8, never above ``tiles``)
      whose CTAs hold u in shared memory with at least 2 ring slots (16,
      non-portable, only where none does), the smallest that gives the
      grid ``FFN8_MIN_CTAS`` CTAs, else the largest: more ranks add
      cluster barriers and LN shares, and a rank's down work (its output
      tiles over the whole of K) does not shrink with them (on the H100,
      c = 2 ran `[8192,320]` in 0.120 ms against c = 4's 0.159, while at
      `[1000,320]` c = 4 ran 0.033 against c = 2's 0.057).  Where no
      cluster of 16 holds u, u goes to a device workspace (``resident``
      False, "spill") at the largest cluster;
    * ``smem``: ``_ffn8_layout``'s bytes, at most 227 KB."""
    if d % 32 or f % 32 or not 0 < d <= MAX_WIDTH or m < 1:
        raise ValueError(f"the int8 FFN kernel needs d % 32 == 0, d <= {MAX_WIDTH} "
                         f"and F % 32 == 0, got d {d}, F {f}")
    tiles = -(-f // FFN8_HB)
    row_tiles = -(-m // FFN8_BM)
    sizes = [c for c in FFN8_CLUSTERS if c <= tiles]
    fit = [c for c in sizes if _ffn8_layout(d, f, c, True)["stages"] >= 2]
    pool = [c for c in fit if c <= 8] or fit
    plan = None
    if pool:
        c = next((c for c in pool if row_tiles * c >= FFN8_MIN_CTAS), pool[-1])
        plan = _ffn8_layout(d, f, c, True)
    else:
        plan = _ffn8_layout(d, f, sizes[-1], False)
        if plan["stages"] < 2:
            raise ValueError(f"the int8 FFN kernel has no layout for d {d}, F {f}: "
                             f"{plan['smem']} bytes of shared memory")
    out_tiles = -(-d // FFN8_BN)
    return dict(plan, path="wgmma", row_tiles=row_tiles, tiles=tiles, out_tiles=out_tiles,
                k_chunks=-(-tiles // 2), grid=(plan["cluster"] * row_tiles,),
                spill_floats=0 if plan["resident"] else
                plan["cluster"] * row_tiles * plan["tpr"] * FFN8_BM * FFN8_HB)


def ffn8_geometry(plan: dict):
    """The C entry's geometry argument of an ``ffn8_plan``: {cluster, tiles
    per rank, stages, resident, y8 bytes, u bytes, shared bytes}."""
    return _build.int_array(tuple(int(plan[k]) for k in (
        "cluster", "tpr", "stages", "resident", "y_bytes", "u_bytes", "smem")))


_FFN8_PLANS: dict = {}


def _ffn8_checked_plan(m, d, f, dtype, device) -> dict:
    """``ffn8_plan``, checked against the card once per shape, dtype and
    device: ``cudaOccupancyMaxActiveClusters`` must hold one cluster."""
    key = (m, d, f, dtype, device)
    plan = _FFN8_PLANS.get(key)
    if plan is None:
        plan = ffn8_plan(m, d, f, dtype)
        geometry = ffn8_geometry(plan)
        fn = _build.entry("fused_ffn_int8", "ldm_fused_ffn_int8_clusters", [
            ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        is_bf16 = int(dtype == torch.bfloat16)
        _build.check(fn(m, is_bf16, is_bf16, geometry, ctypes.byref(out)),
                     "fused_ffn_int8 occupancy query")
        if out.value < 1:
            raise RuntimeError(
                f"fused_ffn_int8: the card holds no cluster of {plan['cluster']} CTAs with "
                f"{plan['smem']} bytes of shared memory, the plan for M {m}, d {d}, F {f}")
        plan = _FFN8_PLANS[key] = dict(plan, geometry=geometry)
    return plan


def _launch_int8(x, ln_scale, ln_bias, q: Int8FFNWeights, b1v, b1g, b2, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_int8 takes CPU or CUDA tensors, got {x.device}")
    b, t, d = x.shape
    f = q.w1v8.shape[0]
    m = b * t
    if b2.dtype != x.dtype:
        raise TypeError(f"b2 is {b2.dtype}, x is {x.dtype}")
    for name, w in zip(q._fields, q):
        want = torch.int8 if name.startswith("w") else torch.float32
        if w.dtype != want:
            raise TypeError(f"{name} is {w.dtype}, want {want}")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    plan = _ffn8_checked_plan(m, d, f, x.dtype, x.get_device())
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view into a row: 16-byte loads need a copy
        x = x.clone()
    lns, lnb = (a.to(device=x.device, dtype=torch.float32).contiguous()
                for a in (ln_scale, ln_bias))
    lns, lnb = (a.clone() if a.data_ptr() % 16 else a for a in (lns, lnb))  # 16-byte loads
    # b1v, b1g as they are in x's type, else in float32 (both exact; one
    # launch a call where the biases come in x's type or float32)
    bias_bf16 = x.dtype == torch.bfloat16 and b1v.dtype == b1g.dtype == torch.bfloat16
    b1v, b1g = (a.contiguous() if bias_bf16 else a.to(torch.float32).contiguous()
                for a in (b1v, b1g))
    fn = _build.entry("fused_ffn_int8", "ldm_fused_ffn_int8", [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    out = torch.empty_like(x)
    u8 = torch.empty((m, f), dtype=torch.int8, device=x.device)  # the down-projection's A
    spill = (torch.empty(plan["spill_floats"], dtype=torch.float32, device=x.device)
             if plan["spill_floats"] else None)
    err = fn(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        q.w1v8.data_ptr(), q.s1v.data_ptr(), b1v.data_ptr(),
        q.w1g8.data_ptr(), q.s1g.data_ptr(), b1g.data_ptr(),
        q.w28.data_ptr(), q.s2.data_ptr(), b2.contiguous().data_ptr(),
        out.data_ptr(), u8.data_ptr(), None if spill is None else spill.data_ptr(),
        m, d, f, float(eps), int(x.dtype == torch.bfloat16), int(bias_bf16), plan["geometry"],
        torch._C._cuda_getCurrentRawStream(x.get_device()),
    )
    _build.check(err, "fused_ffn_int8 kernel launch")
    fused_ffn_int8.launches += 1
    fused_ffn_int8.launches_by_path[plan["path"]] += 1
    return out


def fused_ffn_int8(x, ln_scale, ln_bias, q: Int8FFNWeights, b1v, b1g, b2,
                   eps=1e-5):
    """W8A8 LN -> GEGLU -> dense -> +x over [B, T, d] (any B * T), the
    weights from ``quantize_ffn_weights``: per-row dynamic activation
    scales, per-column weight scales, s8 products, the polynomial GELU.
    x and b2 bf16 or float32; ln_scale, ln_bias, b1v, b1g are applied in
    float32 (on the card a call is one launch where ln_scale and ln_bias
    are float32 and b1v, b1g float32 or x's type).  A CPU tensor takes the
    plain version; a CUDA tensor takes the kernel, or raises.  A
    sampling-only building block, as in the JAX package: it refuses
    differentiation and no path dispatches it.
    ``fused_ffn_int8.launches`` counts kernel launches, ``launches_by_path``
    them by path (all "wgmma": one launch on thread-block clusters, its
    geometry from ``ffn8_plan``)."""
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
fused_ffn_int8.launches_by_path = dict.fromkeys(PATHS, 0)
