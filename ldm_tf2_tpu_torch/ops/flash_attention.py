"""Flash attention: CUDA kernels for CUDA tensors, plain PyTorch for CPU
tensors, differentiable on both.

Counterpart of ``ldm_tf2_tpu.ops.flash_attention.flash_attention``.  The
forward kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``_flash_kernel``; it reads the unpadded ``[B, T, H, S]`` layout directly
(no 128-lane head padding, no head-major relayout).

Differentiation follows the JAX package's ``custom_vjp``: when an input
needs a gradient, ``flash_attention`` runs as a ``torch.autograd.Function``
whose forward also returns the per-row log-sum-exp ``lse`` ([B, H, Tq]
float32, scaled-logit domain) and saves (q, k, v, o, lse); its backward is
FlashAttention-2 on two kernels (``csrc/flash_attention_bwd.cu``, replacing
``_dq_kernel`` and ``_dkv_kernel``), ``di = rowsum(dO * O)`` computed
beside them in PyTorch as the JAX package computes it in XLA.  CPU tensors
take the same Function with the plain forward and the plain backward.
Without a gradient nothing changes: no ``lse`` is written.

``flash_attention_pv_int8`` is the serving mode
``tpu.quantize_attention: int8pv``: the TPU kernel with ``pv_int8=True``
(``csrc/flash_attention_pv_int8.cu``).  Its results depend on the TPU
kernel's kv block (v is quantized per block, p against the running max up
to the block), so that block size, ``jax_block_k``, is copied from the JAX
package as a definition of the function, not as a tuning choice.  It
refuses to be differentiated, as the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ldm_tf2_tpu_torch.ops import _build
from ldm_tf2_tpu_torch.ops import attention as _attention
from ldm_tf2_tpu_torch.ops.attention import dot_product_attention

MAX_HEAD_DIM = 512
_DTYPES = (torch.float32, torch.bfloat16)

# The wgmma path (bf16 at the models' head dims: the U-Net's 40, 80, 160 and
# the autoencoder's 512), per kernel and head dim: (resident rows per CTA,
# streamed tile rows, output columns per CTA, stages, CTAs per SM).
# Resident rows are queries in the forward and dq kernels, keys in dk/dv;
# the streamed tile the other side; 64 rows per consumer warpgroup.  Output
# columns below the head dim split it across CTAs, each recomputing the
# score products (S = 512: a 64 x 512 float32 accumulator is 256 registers
# a thread, and 64-row tiles give only 32-48 CTAs at the autoencoder's
# [2|3, 1024, 1, 512]).  CTAs per SM is the kernel's occupancy target
# (``__launch_bounds__``), which caps its registers.  The CUDA sources hold
# one instantiation per entry and refuse a geometry they do not hold.
WGMMA_TILES = {
    "fwd": {40: (128, 64, 40, 2, 2), 80: (128, 128, 80, 2, 1),
            160: (64, 64, 160, 2, 1), 512: (64, 64, 128, 2, 1)},
    "dq": {40: (128, 64, 40, 2, 1), 80: (128, 64, 80, 2, 1),
           160: (64, 64, 160, 2, 1), 512: (64, 32, 128, 1, 1)},
    "dkv": {40: (128, 64, 40, 2, 1), 80: (128, 64, 80, 2, 1),
            160: (64, 32, 160, 2, 1), 512: (64, 32, 128, 1, 1)},
}
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
SMEM_PER_SM = 233_472  # an SM's shared memory, 1 KB of it reserved per block
PATHS = ("wgmma", "mma.sync", "fma")  # the C entries' path codes 2, 1, 0


def wgmma_geometry(kind: str, s: int, b: int = 1, tq: int = 1, tk: int = 1,
                   h: int = 1):
    """The wgmma path's launch geometry of ``kind`` ("fwd", "dq", "dkv") at
    head dim ``s``, or None where the path has no instantiation.

    Operand tiles are 64-column chunks of 128-byte rows (``csrc/hopper.cuh``):
    ``chunks`` cover the 16-column k-steps of the score products.  Shared
    memory: 1024 bytes to align the base, the resident tiles (Q; or q and
    dO; or k and v), ``stages`` streamed tiles (K and this CTA's V slice; or
    k and v; or q and dO), 64 bytes of barriers.  ``grid``: (row tiles,
    b * h, column slices)."""
    tiles = WGMMA_TILES.get(kind, {}).get(s)
    if tiles is None:
        return None
    rows, tile, cols, stages, ctas = tiles
    ksteps = -(-s // 16)
    chunks = -(-ksteps * 16 // 64)
    if kind == "fwd":
        resident = chunks * rows * 128
        streamed = (chunks + -(-cols // 64)) * tile * 128
    else:
        resident = 2 * chunks * rows * 128
        streamed = 2 * chunks * tile * 128
    smem = 1024 + resident + stages * streamed + 64
    t_rows = tk if kind == "dkv" else tq
    return dict(rows=rows, tile=tile, cols=cols, stages=stages, ctas_per_sm=ctas,
                ksteps=ksteps, chunks=chunks, splits=-(-s // cols), smem_bytes=smem,
                threads=rows // 64 * 128 + 32,
                grid=(-(-t_rows // rows), b * h, -(-s // cols)))


_GEOMETRY_ARGS: dict = {}


def _geometry_arg(kind, q):
    """The C entries' geometry argument: the wgmma path's geometry for bf16
    at an instantiated head dim, else None (the C entry then takes the
    mma.sync or FMA path).  The grid is the C side's; the rest depends on
    the head dim only, so the argument is made once per (kind, s)."""
    if q.dtype != torch.bfloat16:
        return None
    key = (kind, q.shape[-1])
    if key not in _GEOMETRY_ARGS:
        geo = wgmma_geometry(*key)
        _GEOMETRY_ARGS[key] = None if geo is None else (ctypes.c_int * 6)(
            geo["rows"], geo["tile"], geo["cols"], geo["stages"], geo["smem_bytes"],
            geo["ctas_per_sm"])
    return _GEOMETRY_ARGS[key]


_ENTRIES: dict = {}


def _entry(lib: str, symbol: str, n_ptrs: int):
    """A C entry of the flash libraries with its argument types set once:
    ``n_ptrs`` pointers, (b, tq, tk, h, s), scale, is_bf16, geometry,
    path, stream."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


def _count_path(fn, code: int) -> None:
    fn.launches_by_path[PATHS[2 - code]] += 1


def _plain(q, k, v, scale):
    """The plain version: the same function in plain PyTorch."""
    return dot_product_attention(q, k, v, scale)


def _plain_forward(q, k, v, scale):
    """The plain version with the backward's residual: (out, lse), lse the
    row log-sum-exp of the scaled logits, [B, H, Tq] float32."""
    logits = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqc,bchs->bqhs", weights, v)
    return out, torch.logsumexp(logits, dim=-1)


def _check(q, k, v):
    # one pass over the cheap attributes first: the wrappers run once per
    # attention, and their host time is paid before the kernel starts
    qs, ks, vs = q.shape, k.shape, v.shape
    dtype = q.dtype
    if (len(qs) == len(ks) == 4 and ks == vs and ks[0] == qs[0] and ks[2:] == qs[2:]
            and ks[1] >= 1 and dtype in _DTYPES and k.dtype == dtype == v.dtype
            and q.get_device() == k.get_device() == v.get_device()):
        return
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, S], got {tuple(t.shape)}")
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(
            f"q, k, v must share one dtype of {_DTYPES}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not q.get_device() == k.get_device() == v.get_device():
        raise ValueError("q, k, v must be on one device")
    if ks != vs or ks[0] != qs[0] or ks[2:] != qs[2:]:
        raise ValueError(
            f"shape mismatch: q {tuple(qs)}, k {tuple(ks)}, v {tuple(vs)}"
        )
    raise ValueError("attention needs at least one key")


def _check_launch(q, k, v, what):
    if not q.is_cuda:
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {q.shape[-1]} exceeds the kernel's {MAX_HEAD_DIM}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k, v, scale, with_lse=False):
    _check_launch(q, k, v, "flash_attention")
    b, tq, h, s = q.shape
    fn = _entry("flash_attention", "ldm_flash_attention_fwd", 5)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    path = ctypes.c_int(-1)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, tq, k.shape[1], h, s, float(scale),
        int(q.dtype == torch.bfloat16), _geometry_arg("fwd", q),
        ctypes.byref(path), stream,
    )
    _build.check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    _count_path(flash_attention, path.value)
    return (out, lse) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    """The forward with its residual (the kernel, or the plain version on
    CPU tensors) and the FA-2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            out, lse = _plain_forward(q, k, v, scale)
        else:
            out, lse = _launch(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v over [B, T, H, S] tensors (bf16 or f32).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    or raises.  Differentiable on both (see the module docstring).
    ``flash_attention.launches`` counts forward-kernel launches, and
    ``flash_attention.launches_by_path`` the same launches by the path the
    kernel took ("wgmma", "mma.sync" or "fma")."""
    _check(q, k, v)
    if _build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    if q.is_cpu:
        return _plain(q, k, v, scale)
    return _launch(q, k, v, scale)


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)


# ------------------------------------------------------------- backward --

def _plain_probs_and_ds(q, k, v, dout, lse, di, scale):
    """p = exp(scale * q k^T - lse) and ds = p * (dO v^T - di), [B, H, Tq,
    Tk] float32."""
    logits = torch.einsum("bqhs,bchs->bhqc", q.float(), k.float()) * scale
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bqhs,bchs->bhqc", dout.float(), v.float())
    return p, p * (dp - di[..., None])


def _plain_dq(q, k, v, dout, lse, di, scale):
    """The plain version of the dq kernel: dq = scale * ds k."""
    _, ds = _plain_probs_and_ds(q, k, v, dout, lse, di, scale)
    return (torch.einsum("bhqc,bchs->bqhs", ds, k.float()) * scale).to(q.dtype)


def _plain_dkv(q, k, v, dout, lse, di, scale):
    """The plain version of the dk/dv kernel: dk = scale * ds^T q and
    dv = p^T dO."""
    p, ds = _plain_probs_and_ds(q, k, v, dout, lse, di, scale)
    dk = torch.einsum("bhqc,bqhs->bchs", ds, q.float()) * scale
    dv = torch.einsum("bhqc,bqhs->bchs", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _di(out, dout):
    """di = rowsum(dO * O) in float32, [B, H, Tq]."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _check_backward(q, k, v, dout, lse, di):
    _check(q, k, v)
    b, tq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [{b}, {h}, {tq}] float32")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch_backward(name, q, k, v, dout, lse, di, scale, outs):
    _check_launch(q, k, v, f"flash_backward_{name}")
    for what, t in (("dout", dout), ("lse", lse), ("di", di)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    b, tq, h, s = q.shape
    fn = _entry("flash_attention_bwd", f"ldm_flash_attention_bwd_{name}",
                6 + len(outs))
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    path = ctypes.c_int(-1)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), *(o.data_ptr() for o in outs),
        b, tq, k.shape[1], h, s, float(scale),
        int(q.dtype == torch.bfloat16), _geometry_arg(name, q),
        ctypes.byref(path), stream,
    )
    _build.check(err, f"flash_backward_{name} kernel launch")
    return path.value


def flash_backward_dq(q, k, v, dout, lse, di, scale: float):
    """dq of flash attention from the forward's ``lse`` and ``di``.

    A CPU tensor takes the plain version; a CUDA tensor takes the dq kernel,
    or raises.  ``flash_backward_dq.launches`` counts kernel launches,
    ``.launches_by_path`` the same by path."""
    _check_backward(q, k, v, dout, lse, di)
    if q.device.type == "cpu":
        return _plain_dq(q, k, v, dout, lse, di, scale)
    dq = torch.empty_like(q)
    path = _launch_backward("dq", q, k, v, dout, lse, di, scale, (dq,))
    flash_backward_dq.launches += 1
    _count_path(flash_backward_dq, path)
    return dq


flash_backward_dq.launches = 0
flash_backward_dq.launches_by_path = dict.fromkeys(PATHS, 0)


def flash_backward_dkv(q, k, v, dout, lse, di, scale: float):
    """(dk, dv) of flash attention from the forward's ``lse`` and ``di``.

    A CPU tensor takes the plain version; a CUDA tensor takes the dk/dv
    kernel, or raises.  ``flash_backward_dkv.launches`` counts kernel
    launches, ``.launches_by_path`` the same by path."""
    _check_backward(q, k, v, dout, lse, di)
    if q.device.type == "cpu":
        return _plain_dkv(q, k, v, dout, lse, di, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    path = _launch_backward("dkv", q, k, v, dout, lse, di, scale, (dk, dv))
    flash_backward_dkv.launches += 1
    _count_path(flash_backward_dkv, path)
    return dk, dv


flash_backward_dkv.launches = 0
flash_backward_dkv.launches_by_path = dict.fromkeys(PATHS, 0)


def flash_attention_backward(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) from the forward's residuals: di in PyTorch, then the
    dq and dk/dv kernels.  On CPU tensors this is FlashAttention-2's
    backward in plain PyTorch."""
    di = _di(out, dout)
    dq = flash_backward_dq(q, k, v, dout, lse, di, scale)
    dk, dv = flash_backward_dkv(q, k, v, dout, lse, di, scale)
    return dq, dk, dv


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
    launches.  Refuses to be differentiated."""
    _check(q, k, v)
    _build.refuse_grad("flash attention int8-PV (tpu.quantize_attention: int8pv)",
                q, k, v)
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
    """The models' spatial self-attention, by ``attention_impl``
    (``ops.attention.set_attention_impl``): "xla" takes
    ``dot_product_attention``; otherwise ``flash_attention_pv_int8`` when
    the int8-P.V serving mode is on and the JAX package would run its flash
    kernel (q and kv of at least ``PV_INT8_MIN_TOKENS`` tokens, or any
    length under "flash"), else ``flash_attention``."""
    impl = _attention.get_attention_impl()
    if impl == "xla":
        return dot_product_attention(q, k, v, scale)
    if pv_int8 and (impl == "flash"
                    or min(q.shape[1], k.shape[1]) >= PV_INT8_MIN_TOKENS):
        return flash_attention_pv_int8(q, k, v, scale)
    return flash_attention(q, k, v, scale)
