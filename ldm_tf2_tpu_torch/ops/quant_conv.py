"""W8A8 int8 ResBlock chain for serving: GN -> SiLU -> quantize -> s8 3x3
conv -> dequantize (+bias, +time, +residual).

Counterpart of ``ldm_tf2_tpu.ops.quant_conv`` (the serving mode
``tpu.quantize: int8``).  Two kernels carry it on the card:

* ``csrc/gn_silu_quant.cu`` (``gn_silu_quant``) replaces the TPU kernels
  ``_gn_silu_quant_kernel`` and ``_gn_silu_quant_stream_kernel``: f32 group
  statistics (fast variance), normalize, affine, SiLU, per-image scale
  ``sa = max(amax, 1e-8) / 127`` and ``y8 = clip(round(y * (1 / sa)))``,
  in one launch on a thread-block cluster per image whose geometry is
  ``gn_cluster_plan``'s (shared with row 5's GroupNorm).
* ``csrc/s8_conv3x3.cu`` (``s8_conv3x3``) replaces ``_batched_conv_kernel``:
  the s8 x s8 -> s32 3x3 SAME conv with the epilogue
  ``acc * (sa[b] * ws[co]) + b (+t) (+residual)`` in f32, cast to the
  activation dtype.  Launched after the first, it is also the card's form
  of the TPU's whole-chain ``_chain_kernel``.  It runs on s8 ``wgmma`` and
  TMA with the launch geometry of ``s8_conv_plan``.

Weights are quantized once per output channel (``quantize_weight``) when
the mode is switched on: they are frozen at inference.  The s8 kernel reads
them as ``[Cout, 3, 3, Cin]`` so that each output channel's 9 * Cin values
are contiguous, tap-major.

Dispatch semantics: which convs are quantized changes the images, not only
the speed, so the JAX package's shape gate (``use_int8_conv``,
``use_fused_int8_chain``, ``_chain_pick`` and their TPU VMEM models) is
copied here verbatim as pure functions of shape.  The kernels choose their
own tiling.  Like the JAX package's, the int8 path refuses to be
differentiated: both wrappers raise under grad.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops.flash_attention import PATHS, SMS

_DTYPES = (torch.float32, torch.bfloat16)
_MODE = "the int8 conv path (tpu.quantize: int8)"

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

def quantize_cols(w):
    """Per-column symmetric s8 quantization of a 2-D kernel [in, out] from
    its values as stored, cast to float32: ``s = max(max|w| over rows,
    1e-12) / 127``, ``w8 = clip(round(w / s), -127, 127)``.  Returns (w8
    [in, out] int8, s [out] float32)."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=0), min=1e-12) / 127.0
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), s


def quantize_weight(w):
    """``quantize_cols`` of an OIHW kernel, one column per output channel.
    Returns (w8 OIHW int8, ws [Cout] float32)."""
    w8, ws = quantize_cols(w.reshape(w.shape[0], -1).T)
    return w8.T.reshape(w.shape), ws


def quantize_activations(v, dims):
    """Symmetric s8 codes of ``v`` with one scale per slice over ``dims``:
    ``scale = max(max|v|, 1e-8) * (1/127)`` and ``codes = clip(round(v *
    (1 / scale)), -127, 127)``, a multiply by the reciprocal, rounding half
    to even.  Returns (codes as integral floats, scale with ``dims`` kept)."""
    scale = torch.clamp(v.abs().amax(dim=dims, keepdim=True), min=1e-8) * (1.0 / 127.0)
    return torch.clamp(torch.round(v * (1.0 / scale)), -127.0, 127.0), scale


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
    y8, sa = quantize_activations(y * torch.sigmoid(y), (1, 2, 3))
    return y8.to(torch.int8).reshape(b, h, w, c), sa.reshape(b)


# The GroupNorm cluster kernels' launch geometry (``csrc/gn_cluster.cuh``:
# rows 8 and 9 here, row 5 in ``ops/group_norm.py``)
GN_THREADS = 512  # the most threads a CTA runs: rows 8 and 9
GN_SMEM = 232448  # the most shared memory a CTA may have (227 KB): rows 8 and 9
# Row 5's CTAs: two to an SM (the card holds 15 clusters of 8 one-CTA SMs; a
# batch of 4 in 4 slices is 16)
GN_PAIR_THREADS = 256
GN_PAIR_SMEM = 115712  # (228 KB - 2 x 1 KB reserved) / 2
GN_TAIL = 36  # floats after the sums: warp maxima, the amax slots, padding
GN_CLUSTERS = (8, 4, 2, 1)  # the portable cluster sizes, largest first
GN_CTAS = 128  # row 5's slices aim at about one CTA per SM
GN_PATHS = ("resident", "reread")
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _slice_groups(b: int, cluster: int, num_groups: int, cg: int, unit: int) -> int:
    """Row 5's groups per slice: the most (the longest contiguous runs of a
    row) that still give ``GN_CTAS`` CTAs, else the fewest, among the
    divisors of ``num_groups`` whose slice is a whole number of ``unit``
    elements."""
    fits = [d for d in range(num_groups, 0, -1) if num_groups % d == 0 and d * cg % unit == 0]
    enough = [d for d in fits if b * (num_groups // d) * cluster >= GN_CTAS]
    return enough[0] if enough else fits[-1]


def gn_cluster_plan(shape, dtype, per_image: bool, num_groups: int = 32) -> dict:
    """The launch geometry of the GroupNorm cluster kernels for an input of
    ``shape`` [B, ..., C] and ``dtype``, a function of the two alone (so the
    summation order is fixed per shape): ``per_image`` for rows 8 and 9
    (one cluster holds a whole image: the amax couples its groups), else row
    5 (a cluster holds an image's slice of ``gps`` whole groups).

    * ``cluster``: R CTAs, the largest portable size (8, 4, 2, 1) that gives
      every CTA at least one of the HW rows; ``rows`` per CTA;
    * ``gps``: groups per slice (row 5: ``_slice_groups``), ``slices``;
    * ``vec``: elements per load, 16 bytes where C and the slice's ``cw``
      channels are a multiple of 16 bytes, else 1 (the C side also needs a
      16-byte aligned base);
    * ``cols`` vector columns x ``phases`` row phases of threads (a thread
      owns one column and every ``phases``-th row), ``threads`` in whole
      warps, at most ``GN_THREADS`` (row 5: ``GN_PAIR_THREADS``);
    * ``smem``: the kept rows (``keep`` of ``rows``; 16-byte aligned), then
      float32 partial sums (2 x cols x phases x vec), channel sums (2 x
      cw), for rows 8 and 9 each channel's min and max of x (2 x cw), group
      sums and statistics (4 x gps), ``GN_TAIL`` floats; ``mode``
      "resident" where a CTA's rows fit ``GN_SMEM`` (row 5:
      ``GN_PAIR_SMEM``), else "reread": the CTA keeps ``keep`` rows and
      reads the rest again in each later pass.
    ``grid`` is (R, slices, B) in clusters of (R, 1, 1)."""
    b, c = shape[0], shape[-1]
    hw = math.prod(shape[1:-1])
    if c % num_groups or hw < 1:
        raise ValueError(f"no GroupNorm cluster plan for {tuple(shape)} in {num_groups} groups")
    elem, cg = _ELEM[dtype], c // num_groups
    per16 = 16 // elem
    cluster = next(r for r in GN_CLUSTERS if r <= hw and (r - 1) * -(-hw // r) < hw)
    rows = -(-hw // cluster)
    gps = num_groups if per_image else _slice_groups(
        b, cluster, num_groups, cg, per16 if c % per16 == 0 else 1)
    cw = gps * cg
    vec = per16 if c % per16 == 0 and cw % per16 == 0 else 1
    most, budget = (GN_THREADS, GN_SMEM) if per_image else (GN_PAIR_THREADS, GN_PAIR_SMEM)
    cols = min(cw // vec, most)
    phases = min(most // cols, rows)
    fixed = 4 * (2 * cols * phases * vec + (4 if per_image else 2) * cw + 4 * gps + GN_TAIL)
    keep = min(rows, (budget - fixed) // (cw * elem))
    if _align16(keep * cw * elem) + fixed > budget:
        keep -= 1
    if keep < 0:
        raise ValueError(f"no GroupNorm cluster plan for {tuple(shape)}: {fixed} bytes of "
                         f"sums exceed a CTA's shared memory")
    return dict(cluster=cluster, rows=rows, keep=keep, gps=gps, slices=num_groups // gps,
                vec=vec, cols=cols, phases=phases, threads=-(-cols * phases // 32) * 32,
                smem=_align16(keep * cw * elem) + fixed,
                mode="resident" if keep == rows else "reread",
                grid=(cluster, num_groups // gps, b))


def gn_geometry(plan: dict):
    """The C entries' geometry argument of a ``gn_cluster_plan``: {cluster,
    rows, keep, gps, vec, cols, phases, threads, smem}."""
    return _build.int_array(tuple(plan[k] for k in (
        "cluster", "rows", "keep", "gps", "vec", "cols", "phases", "threads", "smem")))


def check_clusters(lib: str, symbol: str, plan: dict, shape, dtype, *lead) -> None:
    """Raise, naming the shape, where the card cannot hold one cluster of
    the plan (``cudaOccupancyMaxActiveClusters`` is 0); ``lead``: the C
    entry's arguments before (is_bf16, geometry, out)."""
    fn = _build.entry(lib, symbol, [ctypes.c_int] * (len(lead) + 1) + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(fn(*lead, int(dtype == torch.bfloat16), gn_geometry(plan), ctypes.byref(out)),
                 f"{symbol} occupancy query")
    if out.value < 1:
        raise RuntimeError(
            f"{lib}: the card holds no cluster of {plan['cluster']} CTAs x {plan['threads']} "
            f"threads with {plan['smem']} bytes of shared memory, the plan for "
            f"{tuple(shape)} {dtype}")


def gn_silu_checks(device) -> list:
    """The counts of ``csrc/gn_silu_quant.cu::silu_checks_kernel`` on a CUDA
    ``device``: floats where the kernels' reciprocal differs from
    ``__frcp_rn`` on [1, 2^126), steps of [-104, 0] where ``expf``
    decreases, negative floats where |silu| reaches the bound the amax
    relies on.  Each must be 0."""
    fn = _build.entry("gn_silu_quant", "ldm_gn_silu_checks", [ctypes.c_void_p] * 2)
    out = torch.empty(3, dtype=torch.int64, device=device)
    _build.check(fn(out.data_ptr(), torch._C._cuda_getCurrentRawStream(out.get_device())),
                 "gn_silu_quant checks launch")
    return out.tolist()


_GNQ_PLANS: dict = {}


def _gnq_plan(x, num_groups: int) -> dict:
    """``gn_cluster_plan`` of a CUDA ``x`` for rows 8 and 9, checked against
    the card once per shape, dtype and device."""
    key = (x.shape, x.dtype, x.get_device(), num_groups)
    plan = _GNQ_PLANS.get(key)
    if plan is None:
        plan = gn_cluster_plan(tuple(x.shape), x.dtype, True, num_groups)
        check_clusters("gn_silu_quant", "ldm_gn_silu_quant_clusters", plan, x.shape, x.dtype,
                       x.shape[0])
        plan = _GNQ_PLANS[key] = dict(plan, geometry=gn_geometry(plan))
    return plan


def _launch_gn_silu_quant(x, gamma, beta, num_groups, eps):
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_quant takes CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    b, h, w, c = x.shape
    plan = _gnq_plan(x, num_groups)
    if plan["vec"] > 1 and x.data_ptr() % 16:  # a view into a row: 16-byte loads need a copy
        x = x.clone()
    fn = _build.entry("gn_silu_quant", "ldm_gn_silu_quant", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                             ctypes.c_void_p])
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    y8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sa = torch.empty(b, dtype=torch.float32, device=x.device)
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y8.data_ptr(), sa.data_ptr(), b,
        h * w, c, num_groups, float(eps), int(x.dtype == torch.bfloat16), plan["geometry"],
        torch._C._cuda_getCurrentRawStream(x.get_device()),
    )
    _build.check(err, "gn_silu_quant kernel launch")
    gn_silu_quant.launches += 1
    gn_silu_quant.launches_by_path[plan["mode"]] += 1
    if _vmem_bytes(h * w, c) > _VMEM_BUDGET:  # where the TPU streams (row 9)
        gn_silu_quant.stream_launches += 1
    return y8, sa


def gn_silu_quant(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm + SiLU + per-image symmetric int8 quantization of NHWC
    ``x``.  Returns (y8 [B, H, W, C] int8, sa [B] float32) with
    ``y8 * sa[b] ~= silu(group_norm(x))``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises: one launch on a thread-block cluster per image
    (``gn_cluster_plan``).  ``gn_silu_quant.launches`` counts kernel
    launches, ``launches_by_path`` them by the plan's mode ("resident":
    the image held in the cluster's shared memory; "reread": rows beyond it
    read again), and ``stream_launches`` those at a shape whose slab does
    not fit the TPU kernel's VMEM, where the JAX package runs its streamed
    kernel instead; one CUDA kernel takes both."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {_DTYPES}, got {x.dtype}")
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    _build.refuse_grad(_MODE, x, gamma, beta)
    if x.device.type == "cpu":
        return _plain_gn_silu_quant(x, gamma, beta, num_groups, eps)
    return _launch_gn_silu_quant(x, gamma, beta, num_groups, eps)


gn_silu_quant.launches = 0
gn_silu_quant.stream_launches = 0
gn_silu_quant.launches_by_path = dict.fromkeys(GN_PATHS, 0)


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


# The wgmma implicit-GEMM convs' instantiations (``csrc/gn_silu_conv3x3.cu``
# in bf16, ``csrc/s8_conv3x3.cu`` in int8): (consumer warpgroups, 64-row
# sub-tiles per warpgroup, N tile) -> ring stages, as many as the shared
# memory holds, at most 8.  A stage is one A tile (the M tile's pixels x one
# 128-byte row of channels: 64 bf16 or 128 s8) and one B tile (N output
# channels x the same channels).
CONV_WGMMA_STAGES = {(1, 1, 128): 8, (1, 1, 160): 8, (2, 1, 128): 7, (2, 1, 160): 6,
                     (2, 2, 128): 4}
# k-steps (one tap, one 128-byte row of channels) a split takes at least
MIN_SPLIT_STEPS = 4
S8_CHUNK = 128  # input channels per k-step of the s8 conv: one 128-byte s8 row


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def conv_tiles(shape, cout: int, chunk: int, two_subtiles_max: int) -> dict:
    """The launch geometry of a wgmma implicit-GEMM 3x3 conv of an input of
    ``shape`` [B, H, W, Cin] and ``cout`` outputs, a k-step being one tap
    and ``chunk`` input channels (one 128-byte swizzled row):

    * an M tile of ``bm`` pixels, 64 rows per sub-tile of a consumer
      warpgroup: one warpgroup of one sub-tile where M = B*H*W <= 64, two
      of two where 128 < M <= ``two_subtiles_max``, else two of one;
    * its TMA box {chunk, bw, bh, bb}: powers of two, bw * bh * bb = bm,
      bw <= 128 (each at most TMA's 256); pixels past the map are
      zero-filled and never stored;
    * an N tile ``bn`` of 160 where it divides Cout and a warpgroup holds
      one sub-tile, else 128 (two sub-tiles of 160 columns would need 160
      accumulator registers a thread);
    * ``9 * ceil(Cin / chunk)`` k-steps, a chunk past Cin zero-filled in
      both operands; ``splits`` of them where the tiles cannot fill the
      card: as many as keep tiles * splits within one wave of ``SMS``, each
      at least ``MIN_SPLIT_STEPS`` k-steps.  Each split writes its own slot
      and a last pass adds them in split order, so the sum's order is a
      function of the shape only;
    * shared memory: 1024 bytes to align, ``stages`` stages, 16 bytes of
      barriers a stage."""
    b, h, w, cin = shape
    m = b * h * w
    nwg, mt = (1, 1) if m <= 64 else (2, 2) if 128 < m <= two_subtiles_max else (2, 1)
    bm = 64 * nwg * mt
    bn = 160 if cout % 160 == 0 and mt == 1 else 128
    bw = min(_pow2_ceil(w), 128, bm)
    bh = min(_pow2_ceil(h), bm // bw)
    bb = bm // (bw * bh)
    tiles_m = -(-w // bw) * -(-h // bh) * -(-b // bb)
    tiles_n = -(-cout // bn)
    k_steps = 9 * -(-cin // chunk)
    splits = max(1, min(SMS // (tiles_m * tiles_n), k_steps // MIN_SPLIT_STEPS))
    per_split = -(-k_steps // splits)
    splits = -(-k_steps // per_split)
    stages = CONV_WGMMA_STAGES[(nwg, mt, bn)]
    stage_bytes = (bm + bn) * 128
    return dict(path="wgmma", warpgroups=nwg, subtiles=mt, bm=bm, bn=bn, box=(bw, bh, bb),
                tiles=(tiles_m, tiles_n), k_steps=k_steps, splits=splits,
                per_split=per_split, stages=stages, stage_bytes=stage_bytes,
                smem_bytes=1024 + stages * (stage_bytes + 16), threads=128 * nwg + 32,
                grid=(tiles_m, tiles_n, splits))


def s8_conv_plan(shape, cout: int) -> dict:
    """The s8 conv's launch geometry for an input of ``shape`` [B, H, W,
    Cin] and ``cout`` outputs (Cin % 32 == 0 and Cout % 8 == 0; the C side
    also needs 16-byte aligned y8 and w8): ``conv_tiles`` with 128-channel
    k-steps (one 128-byte s8 row; where Cin is not a multiple of 128 the
    last chunk is zero-filled, the plan's ``padded_k``) and two sub-tiles a
    warpgroup up to M = 512 (the 8x8 level at CFG batch 8: two tiles of
    four whole images).  Each split's sums are exact s32 integers."""
    plan = conv_tiles(shape, cout, S8_CHUNK, 512)
    plan["padded_k"] = -(-shape[-1] // S8_CHUNK) * S8_CHUNK / shape[-1]
    return plan


def geometry_arg(plan: dict):
    """The C entry's geometry argument for a wgmma conv plan: {bm, bn,
    stages, shared bytes, bw, bh, bb, per_split, consumer warpgroups}."""
    return _build.int_array((plan["bm"], plan["bn"], plan["stages"], plan["smem_bytes"],
                             *plan["box"], plan["per_split"], plan["warpgroups"]))


def _launch_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                       out_dtype):
    if y8.device.type != "cuda":
        raise ValueError(f"s8_conv3x3 takes CPU or CUDA tensors, got {y8.device}")
    b, h, w, cin = y8.shape
    cout = w8.shape[0]
    if cin % 32 or cout % 8:
        raise ValueError(f"the s8 conv kernel needs Cin % 32 == 0 and Cout % 8 == 0, "
                         f"got {cin} and {cout}")
    plan = s8_conv_plan(tuple(y8.shape), cout)
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
    fn = _build.entry("s8_conv3x3", "ldm_s8_conv3x3", [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=y8.device)
    partial = None
    if plan["splits"] > 1:  # each split's exact s32 sums
        partial = torch.empty((plan["splits"], b * h * w, cout), dtype=torch.int32,
                              device=y8.device)
    err = fn(
        y8.data_ptr(), sa.data_ptr(), w8.data_ptr(), ws.data_ptr(),
        bias.data_ptr(), *(None if t is None else t.data_ptr() for t in extras),
        out.data_ptr(), None if partial is None else partial.data_ptr(), b, h, w, cin, cout,
        int(out_dtype == torch.bfloat16), geometry_arg(plan),
        torch._C._cuda_getCurrentRawStream(y8.get_device()),
    )
    _build.check(err, "s8_conv3x3 kernel launch")
    s8_conv3x3.launches += 1
    s8_conv3x3.launches_by_path["wgmma"] += 1
    return out


def s8_conv3x3(y8, sa, w8, ws, bias, *, time_add=None, residual_add=None,
               out_dtype=torch.float32):
    """3x3 SAME s8 conv of y8 [B, H, W, Cin] (int8, per-image scale sa [B])
    with w8 [Cout, 3, 3, Cin] (int8, per-channel scale ws [Cout]), then
    ``acc * (sa[b] * ws[co]) + bias`` (+ time_add [B, Cout]) (+ residual_add
    [B, H, W, Cout]) in float32, cast to ``out_dtype``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  ``s8_conv3x3.launches`` counts kernel calls,
    ``launches_by_path`` them by path (all "wgmma": the kernel has one)."""
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
    _build.refuse_grad(_MODE, sa, ws, bias, time_add, residual_add)
    if y8.device.type == "cpu":
        return _plain_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                                 out_dtype)
    return _launch_s8_conv3x3(y8, sa, w8, ws, bias, time_add, residual_add,
                              out_dtype)


s8_conv3x3.launches = 0
s8_conv3x3.launches_by_path = dict.fromkeys(PATHS, 0)


def gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, b, *, time_add=None,
                         residual_add=None, num_groups: int = 32,
                         eps: float = 1e-5):
    """The int8 twin of ``ops.fused_conv.gn_silu_conv3x3``: ``gn_silu_quant``
    then ``s8_conv3x3`` (two launches on the card), output in x's dtype.
    w8, ws: ``int8_conv_weights`` of the conv kernel.
    ``gn_silu_conv3x3_int8.launches`` counts the pairs launched on the card
    at a shape where the JAX package runs its whole-chain kernel
    (``use_fused_int8_chain``)."""
    y8, sa = gn_silu_quant(x, gamma, beta, num_groups, eps)
    out = s8_conv3x3(y8, sa, w8, ws, b, time_add=time_add,
                     residual_add=residual_add, out_dtype=x.dtype)
    _, h, w, cin = x.shape
    if x.device.type == "cuda" and use_fused_int8_chain(
            h * w, w, cin, w8.shape[0], residual_add is not None):
        gn_silu_conv3x3_int8.launches += 1
    return out


gn_silu_conv3x3_int8.launches = 0
