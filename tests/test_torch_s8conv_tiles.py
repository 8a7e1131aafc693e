"""The s8 conv's plan (``ops/quant_conv.py`` ``s8_conv_plan``, the launch
geometry of ``csrc/s8_conv3x3.cu``) at every int8 chain of the
serving path, read off a meta-device forward of the north-star U-Net at CFG
batch 8, and a CPU mirror of the kernel's tile walk (M tiles as TMA boxes
of whole rows and images, taps, 128-channel chunks, splits of the k-steps,
with TMA's zero fill) held bit-equal to the plain version and to the JAX
package's ``_batched_conv_kernel`` in interpret mode.  The kernel runs only
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import collections
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from ldm_tf2_tpu.ops import quant_conv as jqc
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import quant_conv as tqc
from ldm_tf2_tpu_torch.ops.flash_attention import SMEM_LIMIT, SMEM_PER_SM, SMS

SERVE = sorted({(shape, cout) for shape, cout, _ in chip_smoke.SERVE_CHAINS})


def _int8_chains(monkeypatch):
    """([B, H, W, Cin], Cout, epilogue) of every chain that one north-star
    U-Net eval at CFG batch 8 (32x32 latent) quantizes, on the meta device."""
    chains = []

    def chain(x, gamma, beta, w, b, **kw):
        epilogue = ("t" if kw.get("time_add") is not None else
                    "residual" if kw.get("residual_add") is not None else None)
        chains.append((tuple(x.shape), w.shape[0], epilogue))
        return x.new_empty(*x.shape[:3], w.shape[0])

    monkeypatch.setattr(tunet, "gn_silu_conv3x3", chain)
    monkeypatch.setattr(tunet, "spatial_self_attention",
                        lambda q, k, v, scale, pv_int8=False: torch.empty_like(q))
    monkeypatch.setattr(tunet, "fused_ffn", lambda x, *weights: torch.empty_like(x))
    with torch.device("meta"):
        tm.UNet()(torch.empty(8, 32, 32, 4), torch.empty(8), torch.empty(8, 77, 1280))
    return [c for c in chains if tqc.use_int8_conv(c[0], c[1], 32, c[2] == "residual")]


def test_eval_int8_chains_are_chip_smokes_weights(monkeypatch):
    """``chip_smoke.py`` sums row 11's device times over one eval's 29 int8
    chains with ``SERVE_EVAL_CHAINS`` as weights."""
    counts = collections.Counter(_int8_chains(monkeypatch))
    assert sum(counts.values()) == chip_smoke.SERVE_EVAL["int8_chains"] == 29
    assert dict(counts) == dict(zip(chip_smoke.SERVE_CHAINS, chip_smoke.SERVE_EVAL_CHAINS))


@pytest.mark.parametrize("shape,cout", SERVE)
def test_every_serve_conv_takes_wgmma_and_fits(shape, cout):
    b, h, w, cin = shape
    plan = tqc.s8_conv_plan(shape, cout)
    assert plan["path"] == "wgmma"
    nwg, mt = plan["warpgroups"], plan["subtiles"]
    assert plan["bm"] == 64 * nwg * mt and plan["threads"] == 128 * nwg + 32
    bw, bh, bb = plan["box"]
    assert bw * bh * bb == plan["bm"] and max(bw, bh, bb) <= 256 and bw <= 128
    assert all(n & (n - 1) == 0 for n in (bw, bh, bb))
    # whole rows, and whole images where a tile holds more than one
    assert bw >= w and (bb == 1 or bh >= h)
    tiles_m, tiles_n = plan["tiles"]
    assert tiles_m == -(-w // bw) * -(-h // bh) * -(-b // bb)
    assert tiles_m * plan["bm"] >= b * h * w and tiles_n * plan["bn"] == cout
    k_steps = 9 * -(-cin // 128)
    assert plan["k_steps"] == k_steps
    assert (plan["splits"] - 1) * plan["per_split"] < k_steps <= plan["splits"] * plan["per_split"]
    assert tiles_m * tiles_n * plan["splits"] <= SMS
    assert plan["splits"] == 1 or plan["per_split"] >= tqc.MIN_SPLIT_STEPS
    assert plan["grid"] == (tiles_m, tiles_n, plan["splits"])
    assert plan["smem_bytes"] <= SMEM_LIMIT and plan["smem_bytes"] + 1024 <= SMEM_PER_SM
    assert plan["stages"] == tqc.CONV_WGMMA_STAGES[(nwg, mt, plan["bn"])] >= 4


def test_chunks_past_cin_are_the_padding_the_plan_reports():
    """Cin = 320 and 960 end in a 128-channel chunk that TMA half or a
    quarter zero-fills: 20% and 6.7% more products; the others none."""
    pads = {cin: tqc.s8_conv_plan((8, 16, 16, cin), 640)["padded_k"]
            for cin in (320, 640, 960, 1280, 1920, 2560)}
    assert pads == {320: 1.2, 640: 1.0, 960: 1024 / 960, 1280: 1.0, 1920: 1.0, 2560: 1.0}


@pytest.mark.parametrize("shape,cout,want", [
    # level 0: 64 tiles of 128 pixels (box 32 x 4) x 2 of 160 channels, one wave
    ((8, 32, 32, 320), 320, dict(bm=128, bn=160, box=(32, 4, 1), grid=(64, 2, 1),
                                 per_split=27, stages=6)),
    # 16x16: 16 x 4 tiles, 135 k-steps in 2 splits
    ((8, 16, 16, 1920), 640, dict(bm=128, bn=160, box=(16, 8, 1), grid=(16, 4, 2),
                                  per_split=68, stages=6)),
    # 8x8: 4 whole images a tile (two warpgroups of two sub-tiles), 10 N
    # tiles, 180 k-steps in 6 splits of 30
    ((8, 8, 8, 2560), 1280, dict(bm=256, bn=128, box=(8, 8, 4), grid=(2, 10, 6),
                                 per_split=30, stages=4)),
    # a ragged map and N: pixels past 5 x 7 and channels past 136 are zeros
    ((3, 5, 7, 256), 136, dict(bm=128, bn=128, box=(8, 8, 2), grid=(2, 2, 4),
                               per_split=5, stages=7)),
    # 16 pixels: one warpgroup of one sub-tile
    ((1, 4, 4, 128), 64, dict(bm=64, bn=128, box=(4, 4, 4), grid=(1, 1, 2),
                              per_split=5, stages=8)),
])
def test_plans_by_hand(shape, cout, want):
    plan = tqc.s8_conv_plan(shape, cout)
    assert {k: plan[k] for k in want} == want


def test_shared_memory_bytes_by_hand():
    # two warpgroups, N 160: 6 stages of a 128 x 128-byte A tile and 160 x 128 B
    assert tqc.s8_conv_plan((8, 32, 32, 320), 320)["smem_bytes"] == (
        1024 + 6 * (128 * 128 + 160 * 128) + 6 * 16)
    for (nwg, mt, bn), stages in tqc.CONV_WGMMA_STAGES.items():
        stage = (64 * nwg * mt + bn) * 128 + 16
        assert 1024 + stages * stage <= SMEM_LIMIT < 1024 + (stages + 1) * stage or stages == 8


def test_cin_of_32_times_odd_ends_in_a_zero_filled_chunk():
    """Every Cin % 32 == 0 takes the one path: Cin = 96 is one chunk whose
    last 32 channels TMA zero-fills."""
    plan = tqc.s8_conv_plan((4, 8, 8, 96), 320)
    assert plan["path"] == "wgmma" and plan["k_steps"] == 9
    assert plan["padded_k"] == 128 / 96


def test_geometry_argument():
    plan = tqc.s8_conv_plan((8, 8, 8, 1280), 1280)
    got = tqc.geometry_arg(plan)
    assert isinstance(got, ctypes.Array)
    assert list(got) == [256, 128, 4, plan["smem_bytes"], 8, 8, 4, 15, 2]
    assert tqc.geometry_arg(plan) is got
    # one array per distinct geometry, whichever plan or shape it came from
    assert tqc.geometry_arg(tqc.s8_conv_plan((8, 8, 8, 2560), 1280)) is not got
    assert tqc.geometry_arg(dict(plan)) is got


# ------------------------------------------------------------- the mirror --

def _box(t, start, size):
    """A TMA box of ``t`` (dims outermost first, as torch stores them):
    ``size`` elements from ``start`` in each dim, zeros outside the tensor,
    negative coordinates included."""
    out = torch.zeros(size, dtype=t.dtype)
    src, dst = [], []
    for s0, n, dim in zip(start, size, t.shape):
        lo, hi = max(s0, 0), min(s0 + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _mirror_sums(y8, w8, plan):
    """The wgmma path's walk on the CPU: for each (M tile, N tile, split),
    the split's k-steps, each one tap and 128 channels: the A box {128, bw,
    bh, bb} of y8 at coordinates shifted by the tap, the B box {128, 1, bn}
    of w8 as [Cout, 9, Cin], their s32 product accumulated; a tile's rows
    past the map and columns past Cout computed but not stored; each split's
    sums in its own slot, added in split order.  Returns the sums [B, H, W,
    Cout] (int64)."""
    b, h, w, cin = y8.shape
    cout = w8.shape[0]
    bw, bh, bb = plan["box"]
    bn, per, k_steps = plan["bn"], plan["per_split"], plan["k_steps"]
    tiles_x, tiles_y = -(-w // bw), -(-h // bh)
    wk = w8.reshape(cout, 9, cin)
    slots = torch.zeros((plan["splits"], b, h, w, cout), dtype=torch.int64)
    for tm in range(plan["tiles"][0]):
        x0, y0 = tm % tiles_x * bw, tm // tiles_x % tiles_y * bh
        b0 = tm // (tiles_x * tiles_y) * bb
        hi = (min(b0 + bb, b) - b0, min(y0 + bh, h) - y0, min(x0 + bw, w) - x0)
        for n0 in range(0, plan["tiles"][1] * bn, bn):
            nc = min(n0 + bn, cout) - n0
            for z in range(plan["splits"]):
                acc = torch.zeros((bb * bh * bw, bn), dtype=torch.int64)
                for it in range(z * per, min((z + 1) * per, k_steps)):
                    tap, c0 = it % 9, it // 9 * 128
                    a = _box(y8, (b0, y0 + tap // 3 - 1, x0 + tap % 3 - 1, c0),
                             (bb, bh, bw, 128))
                    bt = _box(wk, (n0, tap, c0), (bn, 1, 128))[:, 0]
                    acc += a.reshape(-1, 128).long() @ bt.long().T
                acc = acc.reshape(bb, bh, bw, bn)
                slots[z, b0:b0 + hi[0], y0:y0 + hi[1], x0:x0 + hi[2], n0:n0 + nc] = \
                    acc[:hi[0], :hi[1], :hi[2], :nc]
    total = torch.zeros_like(slots[0])
    for z in range(plan["splits"]):
        total += slots[z]
    return total


def _mirror(y8, sa, w8, ws, bias, time_add, residual_add, out_dtype, plan):
    """``_mirror_sums`` and the kernel's epilogue, in the plain version's
    float32 order."""
    acc = _mirror_sums(y8, w8, plan).float()
    out = acc * (sa.float()[:, None, None, None] * ws.float())
    out = out + bias.float()
    if time_add is not None:
        out = out + time_add.float()[:, None, None, :]
    if residual_add is not None:
        out = out + residual_add.float()
    return out.to(out_dtype)


def _inputs(rng, shape, cout, epilogue):
    b, h, w, cin = shape
    y8 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8))
    sa = torch.from_numpy((rng.random(b) * 0.01 + 1e-3).astype(np.float32))
    ws = torch.from_numpy((rng.random(cout) * 0.01 + 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    extra = rng.standard_normal((b, cout) if epilogue == "t" else (b, h, w, cout))
    extra = torch.from_numpy(extra.astype(np.float32)).bfloat16()
    return (y8, sa, w8, ws, bias, extra if epilogue == "t" else None,
            extra if epilogue == "residual" else None)


# (shape, Cout, epilogue): two splits of a 9-k-step walk with a half-empty
# chunk; two whole-image tiles of 256 pixels (the 8x8 level's plan) with 5
# splits; a ragged map and N tile; one warpgroup on a 4x4 map; Cin = 32 * 3
# with Cout = 40 (a quarter-empty chunk, an N tile mostly past Cout)
MIRROR_SHAPES = [((2, 8, 8, 64), 96, "t"), ((4, 8, 8, 192), 160, "residual"),
                 ((3, 5, 7, 256), 136, "residual"), ((1, 4, 4, 128), 64, "t"),
                 ((2, 4, 4, 96), 40, "t")]


@pytest.mark.parametrize("shape,cout,epilogue", MIRROR_SHAPES)
def test_mirror_is_bit_equal_to_the_plain_version(shape, cout, epilogue):
    args = _inputs(np.random.default_rng(7), shape, cout, epilogue)
    plan = tqc.s8_conv_plan(shape, cout)
    assert plan["path"] == "wgmma" and plan["splits"] > 1
    for out_dtype in (torch.bfloat16, torch.float32):
        got = _mirror(*args, out_dtype, plan)
        assert torch.equal(got, tqc._plain_s8_conv3x3(*args, out_dtype))


@pytest.mark.parametrize("shape,cout", [(s, c) for s, c, _ in MIRROR_SHAPES]
                         + [((8, 8, 8, 640), 1280)])
def test_walk_takes_every_product_exactly_once(shape, cout):
    """With every code 1 each output's sum counts the products the walk
    made for it: exactly those of the SAME conv, each once (a k-step in two
    splits, a skipped one, or a zero fill in the wrong place shows).  The
    last shape is a serving one: two tiles of four images, six splits."""
    cin = shape[-1]
    ones = torch.ones(shape, dtype=torch.int8)
    got = _mirror_sums(ones, torch.ones((cout, 3, 3, cin), dtype=torch.int8),
                       tqc.s8_conv_plan(shape, cout))
    want = torch.nn.functional.conv2d(ones.permute(0, 3, 1, 2).float(),
                                      torch.ones(cout, cin, 3, 3), padding=1)
    assert torch.equal(got, want.permute(0, 2, 3, 1).long())


def _jax_batched(y8, sa, w8, ws, bias, t, add, out_dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jqc._s8_conv3x3_batched(
            jnp.asarray(y8.numpy()), jnp.asarray(sa.numpy()),
            jnp.asarray(w8.permute(1, 2, 3, 0).numpy()), jnp.asarray(ws.numpy()),
            jnp.asarray(bias.numpy()),
            None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16),
            None if add is None else jnp.asarray(add.float().numpy(), jnp.bfloat16),
            out_dtype, w8.shape[0])
    return np.asarray(out.astype(jnp.float32)).reshape(*y8.shape[:3], w8.shape[0])


def test_mirror_sums_are_bit_equal_to_jax_batched_conv_kernel():
    """The JAX package's s8 conv of the 8x8 level (``_batched_conv_kernel``:
    every image's rows stacked, per-image tap masks) in interpret mode, on
    the same codes: with unit scales, no bias and a float32 output its
    output is its s32 sums (below 2^24, exact in float32)."""
    shape, cout = (2, 8, 8, 64), 96
    y8, _, w8, *_ = _inputs(np.random.default_rng(8), shape, cout, "t")
    b = shape[0]
    want = _jax_batched(y8, torch.ones(b), w8, torch.ones(cout), torch.zeros(cout), None, None,
                        jnp.float32)
    got = _mirror_sums(y8, w8, tqc.s8_conv_plan(shape, cout))
    assert int(got.abs().max()) < 2**24
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("epilogue", ["t", "residual"])
def test_mirror_matches_jax_batched_conv_kernel_with_its_epilogue(epilogue):
    """The whole call against the JAX kernel: XLA on the CPU contracts the
    epilogue's ``acc * s + b`` into one fused multiply-add (one rounding
    where the kernel and the plain version round twice), so an output may
    land one bf16 step away; at most 1 in 1000 do."""
    shape, cout = (2, 8, 8, 64), 96
    args = _inputs(np.random.default_rng(8), shape, cout, epilogue)
    want = _jax_batched(*args, jnp.bfloat16)
    got = _mirror(*args, torch.bfloat16, tqc.s8_conv_plan(shape, cout)).float().numpy()
    step = np.abs(want) * 2.0**-7  # one bf16 step is at most 2^-7 of the value
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got != want) <= 1e-3
