"""The fused FFN's wgmma plan (``ops/fused_ffn.py`` ``ffn_plan``, the launch
geometry of ``csrc/fused_ffn.cu``'s wgmma path) at every FFN of the sampling
and serving paths, read off a meta-device forward of the north-star U-Net
at CFG batch 4 and 8, and a CPU mirror of the kernels' walk (the LayerNorm
rows, the up-projection's row tiles and hidden blocks with u rounded to the
operand type, the down-projection's N tiles and splits added in split
order, the epilogue's roundings) held to the plain version and to the JAX
package's ``_xla_ffn``.  The kernels run only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import collections
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from ldm_tf2_tpu.ops import fused_ffn as jff
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops.flash_attention import SMEM_LIMIT, SMEM_PER_SM, SMS


def _ffn_calls(batch, monkeypatch):
    """[B, T, d] of every FFN one north-star U-Net eval at ``batch`` (a
    32x32 latent) runs, on the meta device."""
    seen = []

    def ffn(x, *weights):
        seen.append(tuple(x.shape))
        return torch.empty_like(x)

    monkeypatch.setattr(tunet, "fused_ffn", ffn)
    monkeypatch.setattr(tunet, "spatial_self_attention",
                        lambda q, k, v, scale, pv_int8=False: torch.empty_like(q))
    with torch.device("meta"):
        tm.UNet()(torch.empty(batch, 32, 32, 4), torch.empty(batch),
                  torch.empty(batch, 77, 1280))
    return seen


@pytest.mark.parametrize("batch", [4, 8])
def test_eval_ffns_are_chip_smokes_shapes_and_weights(batch, monkeypatch):
    """``chip_smoke.py`` sums row 2's device times over one eval's 16 FFNs:
    ``FFN_SHAPES``' first four at CFG batch 4 (the main path), the last
    four at 8 (the serve path and the LDM train step), ``FFN_EVAL`` each."""
    counts = collections.Counter((b * t, d) for b, t, d in _ffn_calls(batch, monkeypatch))
    shapes = chip_smoke.FFN_SHAPES[:4] if batch == 4 else chip_smoke.FFN_SHAPES[4:]
    assert dict(counts) == dict(zip(shapes, chip_smoke.FFN_EVAL))
    assert sum(chip_smoke.FFN_EVAL) == chip_smoke.SERVE_EVAL["ffn"] == 16


@pytest.mark.parametrize("m,d", chip_smoke.FFN_SHAPES)
def test_every_model_ffn_takes_wgmma_and_fits(m, d):
    f = 4 * d
    plan = tff.ffn_plan(m, d, f, torch.bfloat16)
    assert plan["path"] == "wgmma"
    nwg, bm = plan["warpgroups"], plan["bm"]
    assert bm == 64 * nwg and plan["row_tiles"] * bm >= m > (plan["row_tiles"] - 1) * bm
    # the up-projection: every hidden block in exactly one CTA, one wave
    per = plan["up_per"]
    assert plan["hidden_blocks"] == f // 64
    rows, groups = plan["up_grid"]
    assert rows == plan["row_tiles"] and (groups - 1) * per < f // 64 <= groups * per
    assert rows * groups <= SMS
    # the down-projection: N tiles cover d, every hidden k-step in one split
    rows, tiles_n, splits = plan["down_grid"]
    assert tiles_n * plan["bn"] == d and plan["bn"] in (128, 160)
    assert (splits - 1) * plan["per_split"] < f // 64 <= splits * plan["per_split"]
    assert splits == plan["splits"] and rows * tiles_n * splits <= SMS
    assert splits == 1 or plan["per_split"] >= tff.FFN_MIN_SPLIT_STEPS
    for smem in (plan["up_smem"], plan["down_smem"]):
        assert smem <= SMEM_LIMIT and smem + 1024 <= SMEM_PER_SM
    assert plan["up_stages"] == tff.FFN_UP_STAGES[nwg] >= 4
    assert plan["down_stages"] == tff.FFN_DOWN_STAGES[(nwg, plan["bn"])] >= 4


@pytest.mark.parametrize("m,d,want", [
    # level 0 at CFG 4: 32 row tiles x 4 groups of 5 blocks; two N tiles of
    # 160, the 20 hidden k-steps in 2 splits
    (4096, 320, dict(up_per=5, up_grid=(32, 4), bn=160, down_grid=(32, 2, 2),
                     per_split=10)),
    # level 2: two blocks a CTA (one a warpgroup), 80 CTAs; 10 N tiles, 6 splits
    (256, 1280, dict(up_per=2, up_grid=(2, 40), bn=128, down_grid=(2, 10, 6),
                     per_split=14)),
    # the bottleneck at CFG 4: one warpgroup of 64 rows
    (64, 1280, dict(warpgroups=1, up_per=1, up_grid=(1, 80), down_grid=(1, 10, 12),
                    per_split=7)),
    # level 0 at CFG 8: enough row tiles, no split
    (8192, 320, dict(up_per=10, up_grid=(64, 2), down_grid=(64, 2, 1), per_split=20)),
])
def test_plans_by_hand(m, d, want):
    plan = tff.ffn_plan(m, d, 4 * d, torch.bfloat16)
    assert {k: plan[k] for k in want} == want


def test_shared_memory_bytes_by_hand():
    plan = tff.ffn_plan(4096, 320, 1280, torch.bfloat16)
    # 7 stages of a 128 x 64 y slice and two 64 x 64 weight chunks
    assert plan["up_smem"] == 1024 + 7 * (128 * 128 + 2 * 64 * 128 + 16)
    # 5 stages of a 128 x 64 u slice and three 64 x 64 chunks of w2 (N 160)
    assert plan["down_smem"] == 1024 + 5 * (128 * 128 + 3 * 64 * 128 + 16)
    # one warpgroup: 8 stages of a 64 x 64 y slice and two weight chunks
    assert tff.ffn_plan(64, 1280, 5120, torch.bfloat16)["up_smem"] == (
        1024 + 8 * (64 * 128 + 2 * 64 * 128 + 16))


def test_other_dtypes_and_widths():
    assert tff.ffn_plan(4096, 320, 1280, torch.float32) == {"path": "fma"}
    assert tff.ffn_plan(64, 96, 384, torch.bfloat16) == {"path": "fma"}
    assert tff.ffn_plan(64, 320, 1216, torch.bfloat16) == {"path": "fma"}  # F % 128
    assert tff.ffn_plan(64, 1408, 5632, torch.bfloat16) == {"path": "fma"}  # beyond 1280


def test_geometry_argument():
    plan = tff.ffn_plan(256, 1280, 5120, torch.bfloat16)
    got = tff.geometry_arg(plan)
    assert isinstance(got, ctypes.Array)
    assert list(got) == [2, 7, 2, 2, 128, 7, 14, plan["up_smem"], plan["down_smem"]]
    assert tff.geometry_arg(plan) is got


def _turns(nwg, nb):
    """The up-projection's turn passing for a CTA of ``nb`` hidden blocks:
    warpgroup 1 first arrives at barrier 1; before block bl its warpgroup
    (bl % nwg) syncs on barrier 1 + wg, after issuing its products it
    arrives at the other's barrier if block bl + 1 exists.  Returns the
    order in which the warpgroups issue their blocks, run to completion on
    counters (a named barrier completes when 128 syncing and 128 arriving
    threads have reached it), and each barrier's (syncs, arrivals)."""
    if nwg == 1:
        return list(range(nb)), {}
    arrived = {1: 1, 2: 0}
    counts = {1: [0, 1], 2: [0, 0]}
    order, nxt = [], [0, 1]  # each warpgroup's next block
    while any(b < nb for b in nxt):
        progressed = False
        for wg in (0, 1):
            bl = nxt[wg]
            if bl >= nb or arrived[1 + wg] == 0:
                continue
            arrived[1 + wg] -= 1
            counts[1 + wg][0] += 1
            order.append(bl)
            if bl + 1 < nb:
                arrived[2 - wg] += 1
                counts[2 - wg][1] += 1
            nxt[wg] += 2
            progressed = True
        assert progressed, "the warpgroups wait on each other"
    return order, counts


@pytest.mark.parametrize("nwg", [1, 2])
def test_turns_alternate_and_balance(nwg):
    """Blocks are issued in order, one warpgroup's at a time, and every
    named barrier's syncs and arrivals pair up, whatever the CTA's block
    count (the plans give 1 to 20): no arrival is left over at exit."""
    for nb in range(1, 21):
        order, counts = _turns(nwg, nb)
        assert order == list(range(nb))
        assert all(syncs == arrivals for syncs, arrivals in counts.values())


# ------------------------------------------------------------- the mirror --

def _round(v, dtype):
    return v.to(dtype).float()


def _mirror(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, plan, eps=1e-5, counts=None):
    """The wgmma path's walk on the CPU in float32, rounding where the
    kernels round to x's dtype: LN rows into y; for each (row tile, hidden
    group) the group's blocks of 64 columns, block bl by warpgroup bl % nwg
    over the whole row tile, a and g over 64-feature slices, + their biases
    in float32, u = a * gelu(g) rounded; for each
    (row tile, N tile, split) the split's 64-column hidden k-steps, each
    split's sums in its own slot, added in split order from 0; then the
    product rounded, + b2 rounded, + x rounded.  ``counts`` gets how often
    each u element and each (output, k-step) was computed, and which
    warpgroup computed each u element."""
    dt = x.dtype
    m, d = x.shape
    f = w1v.shape[1]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = _round((xf - mu) * torch.rsqrt(var + eps) * lns + lnb, dt)
    bm, hb, per, nwg = plan["bm"], 64, plan["up_per"], plan["warpgroups"]
    u = torch.zeros(m, f)
    u_count = torch.zeros(m, f, dtype=torch.int64)
    u_wg = torch.full((m, f), -1, dtype=torch.int64)
    for r0 in range(0, plan["row_tiles"] * bm, bm):
        rows = slice(r0, min(r0 + bm, m))
        for grp in range(plan["up_grid"][1]):
            for blk in range(grp * per, min((grp + 1) * per, f // hb)):
                cols = slice(blk * hb, (blk + 1) * hb)
                a = torch.zeros(rows.stop - r0, hb)
                g = torch.zeros_like(a)
                for k0 in range(0, d, 64):
                    a += y[rows, k0:k0 + 64] @ w1v[k0:k0 + 64, cols].float()
                    g += y[rows, k0:k0 + 64] @ w1g[k0:k0 + 64, cols].float()
                a = a + b1v[cols].float()
                g = g + b1g[cols].float()
                u[rows, cols] = _round(a * F.gelu(g), dt)
                u_count[rows, cols] += 1
                u_wg[rows, cols] = (blk - grp * per) % nwg
    bn, splits, per_split = plan["bn"], plan["splits"], plan["per_split"]
    slots = torch.zeros(splits, m, d)
    k_count = torch.zeros(m, d, f // 64, dtype=torch.int64)
    for r0 in range(0, plan["row_tiles"] * bm, bm):
        rows = slice(r0, min(r0 + bm, m))
        for n0 in range(0, d, bn):
            for z in range(splits):
                for kc in range(z * per_split, min((z + 1) * per_split, f // 64)):
                    ks = slice(kc * 64, kc * 64 + 64)
                    slots[z, rows, n0:n0 + bn] += u[rows, ks] @ w2[ks, n0:n0 + bn].float()
                    k_count[rows, n0:n0 + bn, kc] += 1
    acc = torch.zeros(m, d)
    for z in range(splits):
        acc = acc + slots[z]
    out = _round(_round(acc, dt) + b2.float(), dt) + xf
    if counts is not None:
        counts.update(u=u_count, k=k_count, wg=u_wg)
    return out.to(dt)


def _inputs(rng, m, d, f, dtype):
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = t(m, d).to(dtype)
    lns, lnb = t(d, scale=0.1) + 1.0, t(d, scale=0.1)
    ws = [t(d, f, scale=d**-0.5), t(f, scale=0.1), t(d, f, scale=d**-0.5), t(f, scale=0.1),
          t(f, d, scale=f**-0.5), t(d, scale=0.1)]
    return x, lns, lnb, [w.to(dtype) for w in ws]


# (m, d): a ragged second row tile and two N tiles of 160, 5 splits; one
# warpgroup and 12 splits; a ragged single row tile and 5 N tiles of 128
MIRROR_SHAPES = [(130, 320), (64, 1280), (40, 640)]


@pytest.mark.parametrize("m,d", MIRROR_SHAPES)
def test_walk_computes_every_hidden_and_product_once(m, d):
    f = 4 * d
    plan = tff.ffn_plan(m, d, f, torch.bfloat16)
    x, lns, lnb, ws = _inputs(np.random.default_rng(3), m, d, f, torch.float32)
    counts = {}
    _mirror(x, lns, lnb, *ws, plan, counts=counts)
    assert bool((counts["u"] == 1).all()) and bool((counts["k"] == 1).all())
    # with two warpgroups each takes every other block of its CTA, all rows
    per, nwg = plan["up_per"], plan["warpgroups"]
    blocks = torch.arange(f) // 64
    assert torch.equal(counts["wg"], ((blocks % per) % nwg).expand(m, f))


@pytest.mark.parametrize("m,d", MIRROR_SHAPES)
def test_mirror_float32_is_the_plain_version(m, d):
    """Without the roundings the walk is the plain function: float32 to
    summation order (1e-5), against ``_plain_ffn`` and the JAX package's
    ``_xla_ffn``."""
    f = 4 * d
    x, lns, lnb, ws = _inputs(np.random.default_rng(4), m, d, f, torch.float32)
    plan = tff.ffn_plan(m, d, f, torch.bfloat16)
    got = _mirror(x, lns, lnb, *ws, plan)
    want = tff._plain_ffn(x[None], lns, lnb, *ws)[0]
    jax_want = np.asarray(jff._xla_ffn(jnp.asarray(x.numpy()), lns.numpy(), lnb.numpy(),
                                       *[jnp.asarray(w.numpy()) for w in ws], 1e-5))
    for ref in (want.numpy(), jax_want):
        assert float(np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)) < 1e-5


@pytest.mark.parametrize("m,d", MIRROR_SHAPES)
def test_mirror_bf16_matches_the_plain_version_and_jax(m, d):
    """In bf16 the walk rounds where the kernels do (y, u, the epilogue's
    three steps); the plain version and ``_xla_ffn`` round a and g as well,
    and add b2 and x in another order: within ``chip_smoke.FFN_TOL``'s bf16
    bounds (max abs 0.1, rel L2 1e-2)."""
    f = 4 * d
    x, lns, lnb, ws = _inputs(np.random.default_rng(5), m, d, f, torch.bfloat16)
    plan = tff.ffn_plan(m, d, f, torch.bfloat16)
    got = _mirror(x, lns, lnb, *ws, plan).float().numpy()
    want = tff._plain_ffn(x[None], lns, lnb, *ws)[0].float().numpy()
    jax_want = np.asarray(jff._xla_ffn(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), lns.numpy(), lnb.numpy(),
        *[jnp.asarray(w.float().numpy(), jnp.bfloat16) for w in ws], 1e-5).astype(jnp.float32))
    tol_abs, tol_rel = chip_smoke.FFN_TOL["bfloat16"]
    for ref in (want, jax_want):
        assert float(np.abs(got - ref).max()) < tol_abs
        assert float(np.linalg.norm(got - ref) / np.linalg.norm(ref)) < tol_rel
