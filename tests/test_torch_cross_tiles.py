"""The short-kv cross-attention's plan (``ops/cross_attention.py``
``cross_plan``, the launch geometry of ``csrc/cross_attention.cu``'s wgmma
path) at the U-Net's four cross-attentions, read off a meta-device forward
with the packed-cross switch on.  The kernel runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import ctypes

import pytest
import torch

from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import attention as tatt
from ldm_tf2_tpu_torch.ops import cross_attention as tca
from ldm_tf2_tpu_torch.ops.flash_attention import SMEM_LIMIT, SMS

# (B, Tq, Tk, H, S): the opt-in main path's cross-attentions (chip_smoke.OPT_CROSS)
OPT_CROSS = [(4, 1024, 77, 8, 40), (4, 256, 77, 8, 80), (4, 64, 77, 8, 160),
             (4, 16, 77, 8, 160)]


def test_meta_forward_runs_the_listed_cross_attentions(monkeypatch):
    seen = []

    def cross(q, k, v, scale):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
        return torch.empty_like(q)

    monkeypatch.setattr(tunet, "cross_attention", cross)
    monkeypatch.setattr(tunet, "gn_silu_conv3x3",
                        lambda x, g, b, w, bias, **kw: x.new_empty(*x.shape[:3], w.shape[0]))
    monkeypatch.setattr(tunet, "spatial_self_attention",
                        lambda q, k, v, scale, pv_int8=False: torch.empty_like(q))
    monkeypatch.setattr(tunet, "fused_ffn", lambda x, *weights: torch.empty_like(x))
    tatt.set_packed_cross(True)
    try:
        with torch.device("meta"):
            tunet.UNet()(torch.empty(4, 32, 32, 4), torch.empty(4), torch.empty(4, 77, 1280))
    finally:
        tatt.set_packed_cross(False)
    assert len(seen) == 16 and sorted(set(seen)) == sorted(OPT_CROSS)


@pytest.mark.parametrize("b,tq,tk,h,s", OPT_CROSS)
def test_every_unet_cross_attention_takes_wgmma_and_fits(b, tq, tk, h, s):
    plan = tca.cross_plan(b, tq, tk, h, s, torch.bfloat16)
    assert plan["path"] == "wgmma"
    # Q K^T's k-steps cover the head with at most one zero-filled k-step;
    # the 64-column chunks cover the k-steps and w V's s output columns
    assert s <= plan["ksteps"] * 16 < s + 16
    assert plan["chunks"] * 64 >= plan["ksteps"] * 16 > (plan["chunks"] - 1) * 64
    assert tk <= tca.CROSS_KEYS and tca.CROSS_KEYS % 16 == 0
    # every query tile in exactly one CTA; K and V once per CTA
    tiles = -(-tq // tca.CROSS_ROWS)
    groups, heads = plan["grid"]
    assert heads == b * h and (groups - 1) * plan["per_cta"] < tiles <= groups * plan["per_cta"]
    assert groups * heads <= max(SMS, heads)
    # two warpgroups on alternate tiles where a CTA has two or more, each
    # with its own ring stages
    assert plan["warpgroups"] == (2 if plan["per_cta"] >= 2 else 1)
    assert plan["stages"] == tca.CROSS_STAGES * plan["warpgroups"]
    assert plan["threads"] == 128 * plan["warpgroups"] + 32
    assert plan["smem_bytes"] <= SMEM_LIMIT and 1 + 2 * plan["stages"] <= 16


@pytest.mark.parametrize("shape,grid,per_cta,nwg", [
    ((4, 1024, 77, 8, 40), (4, 32), 4, 2),   # level 0: 16 tiles a head in 4 CTAs
    ((4, 256, 77, 8, 80), (4, 32), 1, 1),
    ((4, 64, 77, 8, 160), (1, 32), 1, 1),
    ((4, 16, 77, 8, 160), (1, 32), 1, 1),    # one tile, 48 of its rows zeros
    ((1, 1000, 77, 1, 40), (16, 1), 1, 1),   # one head: a CTA a tile
    ((2, 4096, 77, 8, 80), (8, 16), 8, 2),   # 64 tiles a head in 8 CTAs of 8
])
def test_grid_by_hand(shape, grid, per_cta, nwg):
    plan = tca.cross_plan(*shape, torch.bfloat16)
    assert (plan["grid"], plan["per_cta"], plan["warpgroups"]) == (grid, per_cta, nwg)


def test_shared_memory_bytes_by_hand():
    # S = 40: one 64-column chunk; K and V 80 keys; two warpgroups' four Q
    # stages of 64 rows; 128 bytes of barriers
    assert tca.cross_plan(4, 1024, 77, 8, 40, torch.bfloat16)["smem_bytes"] == (
        1024 + 2 * 80 * 64 * 2 + 4 * 64 * 64 * 2 + 128)
    # S = 160: three chunks (160 columns and 32 zeros); one warpgroup, two stages
    assert tca.cross_plan(4, 64, 77, 8, 160, torch.bfloat16)["smem_bytes"] == (
        1024 + 2 * 80 * 192 * 2 + 2 * 64 * 192 * 2 + 128)


def test_other_shapes_keep_their_paths():
    assert tca.cross_plan(4, 1024, 77, 8, 40, torch.float32) == {"path": "fma"}
    assert tca.cross_plan(2, 100, 128, 2, 64, torch.bfloat16) == {"path": "mma.sync"}
    assert tca.cross_plan(2, 100, 81, 2, 40, torch.bfloat16) == {"path": "mma.sync"}
    assert tca.cross_plan(1, 33, 5, 1, 24, torch.bfloat16) == {"path": "mma.sync"}
    assert tca.cross_plan(1, 33, 5, 1, 20, torch.bfloat16) == {"path": "fma"}
    assert tca.cross_plan(2, 100, 80, 2, 40, torch.bfloat16)["path"] == "wgmma"


def test_geometry_argument():
    plan = tca.cross_plan(4, 1024, 77, 8, 40, torch.bfloat16)
    got = tca.geometry_arg(plan)
    assert isinstance(got, ctypes.Array)
    assert list(got) == [64, 80, 4, plan["smem_bytes"], 4, 2]
    assert tca.geometry_arg(plan) is got


def test_cpu_cross_attention_counts_no_path():
    fn = tca.cross_attention
    before = (fn.launches, dict(fn.launches_by_path))
    q = torch.randn(1, 64, 2, 40, dtype=torch.bfloat16)
    k = torch.randn(1, 77, 2, 40, dtype=torch.bfloat16)
    fn(q, k, k, 0.1)
    assert (fn.launches, fn.launches_by_path) == before
    assert set(fn.launches_by_path) == {"wgmma", "mma.sync", "fma"}
