"""The fused chain's conv plan (``ops/fused_conv.py`` ``conv_plan``, the
launch geometry of ``csrc/gn_silu_conv3x3.cu``'s wgmma path) at every chain
shape of the opt-in main path, read off a meta-device forward of the
north-star U-Net and KL decoder, and the wgmma path's weight relayout and
its cache.  The kernel runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import ctypes
import gc
import weakref

import pytest
import torch

from ldm_tf2_tpu_torch.models import autoencoder as tae
from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import fused_conv as tfc
from ldm_tf2_tpu_torch.ops import quant_conv as tqc
from ldm_tf2_tpu_torch.ops.flash_attention import SMEM_LIMIT, SMEM_PER_SM, SMS

# The opt-in main path's ResBlock chains (chip_smoke.OPT_CHAINS): the
# U-Net's 18 distinct at CFG batch 4 (32x32 latent), then the KL decoder's
# 10 at batch 2 (256^2)
OPT_CHAINS = [
    ((4, 32, 32, 320), 320), ((4, 16, 16, 320), 640), ((4, 16, 16, 640), 640),
    ((4, 8, 8, 640), 1280), ((4, 8, 8, 1280), 1280), ((4, 4, 4, 1280), 1280),
    ((4, 4, 4, 2560), 1280), ((4, 8, 8, 2560), 1280), ((4, 8, 8, 1920), 1280),
    ((4, 16, 16, 1920), 640), ((4, 16, 16, 1280), 640), ((4, 16, 16, 960), 640),
    ((4, 32, 32, 960), 320), ((4, 32, 32, 640), 320),
    ((2, 32, 32, 512), 512), ((2, 64, 64, 512), 512), ((2, 128, 128, 512), 256),
    ((2, 128, 128, 256), 256), ((2, 256, 256, 256), 128), ((2, 256, 256, 128), 128),
]


def _chains_of(forward, modules, monkeypatch, epilogues=None):
    """([B, H, W, Cin], Cout) of every chain ``forward()`` runs on the meta
    device, the attentions and FFNs stubbed; ``epilogues`` gets each
    chain's epilogue ("t", "residual" or None)."""
    seen = []

    def chain(x, gamma, beta, w, b, **kw):
        seen.append((tuple(x.shape), w.shape[0]))
        if epilogues is not None:
            epilogues.append("t" if kw.get("time_add") is not None else
                             "residual" if kw.get("residual_add") is not None else None)
        return x.new_empty(*x.shape[:3], w.shape[0])

    for mod in modules:
        monkeypatch.setattr(mod, "gn_silu_conv3x3", chain)
        monkeypatch.setattr(mod, "spatial_self_attention",
                            lambda q, k, v, scale, pv_int8=False: torch.empty_like(q))
    monkeypatch.setattr(tunet, "fused_ffn", lambda x, *weights: torch.empty_like(x))
    with torch.device("meta"):
        forward()
    return seen


def test_meta_forwards_run_the_listed_chains(monkeypatch):
    unet = _chains_of(lambda: tunet.UNet()(torch.empty(4, 32, 32, 4), torch.empty(4),
                                           torch.empty(4, 77, 1280)), [tunet], monkeypatch)
    decoder = _chains_of(lambda: tae.AutoencoderKL().decode(torch.empty(2, 32, 32, 4)),
                         [tae], monkeypatch)
    assert (len(unet), len(decoder)) == (44, 28)
    assert sorted(set(unet + decoder)) == sorted(OPT_CHAINS)


def test_eval_chain_counts_are_chip_smokes_weights(monkeypatch):
    """``chip_smoke.py`` sums row 7's device times over one eval's chains
    with ``OPT_EVAL_CHAINS`` as weights: the count of each distinct chain."""
    import collections

    import chip_smoke

    epilogues = []
    unet = _chains_of(lambda: tunet.UNet()(torch.empty(4, 32, 32, 4), torch.empty(4),
                                           torch.empty(4, 77, 1280)),
                      [tunet], monkeypatch, epilogues)
    counts = collections.Counter((s, c, e) for (s, c), e in zip(unet, epilogues))
    listed = chip_smoke.OPT_CHAINS[:len(chip_smoke.OPT_EVAL_CHAINS)]
    assert dict(counts) == dict(zip(listed, chip_smoke.OPT_EVAL_CHAINS))
    assert sum(chip_smoke.OPT_EVAL_CHAINS) == chip_smoke.OPT_EVAL["gn_silu_conv3x3_fused"]


def test_vq_decoder_chains_take_wgmma(monkeypatch):
    """The repo's VQ autoencoder (channels 128, multipliers 1, 2, 2, 4) at
    256^2: every chain of its decoder on the wgmma path in bf16."""
    vq = _chains_of(lambda: tae.AutoencoderVQ().decoder(torch.empty(2, 32, 32, 4)),
                    [tae], monkeypatch)
    assert len(vq) == 28
    for shape, cout in set(vq):
        assert tfc.conv_plan(shape, cout, torch.bfloat16)["path"] == "wgmma", shape


@pytest.mark.parametrize("shape,cout", OPT_CHAINS)
def test_every_model_chain_takes_wgmma_and_fits(shape, cout):
    b, h, w, cin = shape
    plan = tfc.conv_plan(shape, cout, torch.bfloat16)
    assert plan["path"] == "wgmma"
    nwg, mt = plan["warpgroups"], plan["subtiles"]
    assert plan["bm"] == 64 * nwg * mt and plan["threads"] == 128 * nwg + 32
    # the TMA box: powers of two covering bm pixels, each within TMA's 256
    bw, bh, bb = plan["box"]
    assert bw * bh * bb == plan["bm"] and max(bw, bh, bb) <= 256 and bw <= 128
    assert all(d & (d - 1) == 0 for d in (bw, bh, bb))
    # tiles cover the map and the output channels; a tile's rows past the
    # map are TMA's zeros, never stored
    tiles_m, tiles_n = plan["tiles"]
    assert tiles_m == -(-w // bw) * -(-h // bh) * -(-b // bb)
    assert tiles_m * plan["bm"] >= b * h * w and tiles_n * plan["bn"] >= cout
    assert plan["bn"] in (128, 160) and cout % plan["bn"] == 0
    # split-K: every k-step in exactly one split, one wave of CTAs
    k_steps = 9 * cin // 64
    assert plan["k_steps"] == k_steps
    assert (plan["splits"] - 1) * plan["per_split"] < k_steps <= plan["splits"] * plan["per_split"]
    assert plan["splits"] == 1 or tiles_m * tiles_n * plan["splits"] <= SMS
    assert plan["splits"] == 1 or plan["per_split"] >= tqc.MIN_SPLIT_STEPS
    assert plan["grid"] == (tiles_m, tiles_n, plan["splits"])
    # one CTA a multiprocessor: the ring fills the shared memory
    assert plan["smem_bytes"] <= SMEM_LIMIT and plan["smem_bytes"] + 1024 <= SMEM_PER_SM
    assert plan["stages"] == tqc.CONV_WGMMA_STAGES[(nwg, mt, plan["bn"])] >= 4


def test_m_at_most_256_is_one_tile_so_weights_are_read_once():
    for shape, cout in OPT_CHAINS:
        b, h, w, _ = shape
        plan = tfc.conv_plan(shape, cout, torch.bfloat16)
        assert (plan["tiles"][0] == 1) == (b * h * w <= 256), shape


def test_float32_takes_fma_and_other_bf16_shapes_mma_sync():
    for shape, cout in OPT_CHAINS:
        assert tfc.conv_plan(shape, cout, torch.float32) == {"path": "fma"}
    assert tfc.conv_plan((2, 8, 8, 96), 64, torch.bfloat16) == {"path": "mma.sync"}
    assert tfc.conv_plan((2, 8, 8, 48), 64, torch.bfloat16) == {"path": "fma"}
    assert tfc.conv_plan((2, 8, 8, 128), 36, torch.bfloat16) == {"path": "mma.sync"}


@pytest.mark.parametrize("shape,cout,want", [
    # level 0: 32 tiles of 128 pixels (box 32 x 4) x 2 of 160 channels, K split in 2
    ((4, 32, 32, 320), 320, dict(bm=128, bn=160, box=(32, 4, 1), grid=(32, 2, 2),
                                 per_split=23, stages=6)),
    # 16x16 at Cin 1920: 8 x 4 tiles, 270 k-steps in 4 splits of 68
    ((4, 16, 16, 1920), 640, dict(bm=128, bn=160, box=(16, 8, 1), grid=(8, 4, 4),
                                  per_split=68, stages=6)),
    # 8x8: all 256 pixels in one tile (two warpgroups of two sub-tiles), 10 N tiles
    ((4, 8, 8, 2560), 1280, dict(bm=256, bn=128, box=(8, 8, 4), grid=(1, 10, 13),
                                 per_split=28, stages=4)),
    # 4x4: 64 pixels, one warpgroup, 8 N tiles of 160, 15 splits of 12
    ((4, 4, 4, 1280), 1280, dict(bm=64, bn=160, box=(4, 4, 4), grid=(1, 8, 15),
                                 per_split=12, stages=8)),
    # the decoder at 256^2: rows of 128 pixels, 1024 tiles, no split
    ((2, 256, 256, 128), 128, dict(bm=128, bn=128, box=(128, 1, 1), grid=(1024, 1, 1),
                                   per_split=18, stages=7)),
    # a ragged map and N: an 8 x 8 box per tile, pixels past 5 x 7 and
    # channels past 136 are zeros; 18 k-steps in 4 splits of at least 4
    ((3, 5, 7, 128), 136, dict(bm=128, bn=128, box=(8, 8, 2), grid=(2, 2, 4),
                               per_split=5, stages=7)),
])
def test_plans_by_hand(shape, cout, want):
    plan = tfc.conv_plan(shape, cout, torch.bfloat16)
    assert {k: plan[k] for k in want} == want


def test_shared_memory_bytes_by_hand():
    # two warpgroups, N 160: 6 stages of a 128 x 64 A tile and a 160 x 64 B tile
    assert tfc.conv_plan((4, 32, 32, 320), 320, torch.bfloat16)["smem_bytes"] == (
        1024 + 6 * (128 * 64 * 2 + 160 * 64 * 2) + 6 * 16)
    # two warpgroups of two sub-tiles: 4 stages of 256 x 64 and 128 x 64
    assert tfc.conv_plan((4, 8, 8, 1280), 1280, torch.bfloat16)["smem_bytes"] == (
        1024 + 4 * (256 * 64 * 2 + 128 * 64 * 2) + 4 * 16)
    # one warpgroup: 8 stages of 64 x 64 and 160 x 64
    assert tfc.conv_plan((4, 4, 4, 2560), 1280, torch.bfloat16)["smem_bytes"] == (
        1024 + 8 * (64 * 64 * 2 + 160 * 64 * 2) + 8 * 16)
    for (nwg, mt, bn), stages in tqc.CONV_WGMMA_STAGES.items():
        stage = (64 * nwg * mt + bn) * 128 + 16
        assert 1024 + stages * stage <= SMEM_LIMIT < 1024 + (stages + 1) * stage or stages == 8


def test_split_order_is_a_function_of_the_shape():
    """The partial sums go to fixed slots and are added in split order by
    one pass, so results repeat; the plan, and with it the order, depends on
    the shape alone."""
    a = tfc.conv_plan((4, 8, 8, 1920), 1280, torch.bfloat16)
    b = tfc.conv_plan((4, 8, 8, 1920), 1280, torch.bfloat16)
    assert a == b and a["splits"] == 13 and a["per_split"] == 21
    assert [min(a["per_split"], a["k_steps"] - z * a["per_split"])
            for z in range(a["splits"])] == [21] * 12 + [18]


def test_geometry_argument():
    plan = tfc.conv_plan((4, 4, 4, 2560), 1280, torch.bfloat16)
    got = tfc.geometry_arg(plan)
    assert isinstance(got, ctypes.Array)
    assert list(got) == [64, 160, 8, plan["smem_bytes"], 4, 4, 4, 23, 1]
    assert tfc.geometry_arg(plan) is got


def test_relayout_is_tap_major_cin_contiguous():
    w = torch.randn(6, 5, 3, 3)
    got = tfc.relaid_weight(w, torch.bfloat16)
    assert got.shape == (9, 6, 5) and got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 6, 5))
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(got[3 * ky + kx], w[:, :, ky, kx].to(torch.bfloat16))


def test_relayout_cache_hits_relays_on_update_and_frees_with_the_weight():
    count = tfc.gn_silu_conv3x3_fused.relayouts
    w = torch.nn.Parameter(torch.randn(8, 4, 3, 3))
    first = tfc.relaid_weight(w, torch.bfloat16)
    assert tfc.gn_silu_conv3x3_fused.relayouts == count + 1
    assert tfc.relaid_weight(w, torch.bfloat16) is first
    assert tfc.gn_silu_conv3x3_fused.relayouts == count + 1
    with torch.no_grad():
        w.add_(1)  # an in-place step bumps the version
    second = tfc.relaid_weight(w, torch.bfloat16)
    assert second is not first and tfc.gn_silu_conv3x3_fused.relayouts == count + 2
    assert torch.equal(second, w.detach().to(torch.bfloat16).permute(2, 3, 0, 1)
                       .reshape(9, 8, 4))
    other = tfc.relaid_weight(w, torch.float32)  # another dtype is another copy
    assert other.dtype == torch.float32 and tfc.gn_silu_conv3x3_fused.relayouts == count + 3
    copy = weakref.ref(tfc.relaid_weight(w, torch.float32))
    key = id(w)
    assert key in tfc._RELAID
    del w, first, second, other
    gc.collect()
    assert copy() is None and key not in tfc._RELAID


def test_cpu_chain_counts_no_launch_and_no_relayout():
    fn = tfc.gn_silu_conv3x3_fused
    before = (fn.launches, dict(fn.launches_by_path), fn.relayouts)
    x = torch.randn(1, 4, 4, 64, dtype=torch.bfloat16)
    fn(x, torch.ones(64), torch.zeros(64), torch.randn(64, 64, 3, 3), torch.zeros(64))
    assert (fn.launches, fn.launches_by_path, fn.relayouts) == before
    assert set(fn.launches_by_path) == {"wgmma", "mma.sync", "fma"}
