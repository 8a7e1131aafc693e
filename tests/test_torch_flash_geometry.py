"""The wgmma flash kernels' launch geometry (``wgmma_geometry``), which the
wrappers hand to the CUDA entries and which the CUDA sources check against
their own instantiations: for every head dim the models use, in every
kernel, it fits the card and covers the work exactly.  The kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``)."""

import ctypes

import pytest
import torch

from ldm_tf2_tpu_torch.ops import flash_attention as tfa

HEAD_DIMS = (40, 80, 160, 512)
KINDS = ("fwd", "dq", "dkv", "pv8")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", HEAD_DIMS)
def test_geometry_fits_the_card_and_covers_the_head(kind, s):
    geo = tfa.wgmma_geometry(kind, s)
    assert geo["smem_bytes"] <= tfa.SMEM_LIMIT == 232_448
    assert geo["ctas_per_sm"] * (geo["smem_bytes"] + 1024) <= tfa.SMEM_PER_SM
    assert geo["ctas_per_sm"] * geo["threads"] <= 2048
    assert geo["rows"] % 64 == 0 and geo["rows"] <= 128  # one or two consumer warpgroups
    assert geo["threads"] == geo["rows"] // 64 * 128 + 32  # + the producer warp
    assert geo["tile"] % 16 == 0 and geo["tile"] <= 256  # a wgmma N / k-step multiple; a TMA box
    assert geo["cols"] % 8 == 0 and geo["cols"] <= 256  # a wgmma N
    assert geo["stages"] in (1, 2)
    # the k-steps of the score products cover the head dim with zero-filled
    # columns of at most one k-step; the column slices cover it exactly
    # once, each after the first starting at a 64-column chunk
    assert s <= geo["ksteps"] * 16 < s + 16
    assert geo["chunks"] == -(-geo["ksteps"] * 16 // 64)
    assert (geo["splits"] - 1) * geo["cols"] < s <= geo["splits"] * geo["cols"]
    assert geo["splits"] == 1 or geo["cols"] % 64 == 0


def test_shared_memory_bytes_by_hand():
    # forward S = 512: Q 64 x 512, two stages of K 64 x 512 and a 128-column V slice
    assert tfa.wgmma_geometry("fwd", 512)["smem_bytes"] == (
        1024 + 64 * 512 * 2 + 2 * (64 * 512 * 2 + 64 * 128 * 2) + 64)
    # forward S = 40: 64-column chunks (40 padded with zeros by TMA); Q 128
    # rows, two stages of 64-key K and V tiles
    assert tfa.wgmma_geometry("fwd", 40)["smem_bytes"] == (
        1024 + 128 * 64 * 2 + 2 * (64 * 64 * 2 + 64 * 64 * 2) + 64)
    # dk/dv S = 512: resident k, v 64 x 512; one stage of q, dO 32 x 512
    assert tfa.wgmma_geometry("dkv", 512)["smem_bytes"] == (
        1024 + 2 * 64 * 512 * 2 + 1 * 2 * 32 * 512 * 2 + 64)


def test_pv8_shared_memory_bytes_by_hand():
    # S = 512: Q 64 x 512 resident; two stages of a 64-key K tile (64 x 512)
    # and a 128-key v8 tile of the CTA's 128 columns; 128 bytes of barriers
    assert tfa.wgmma_geometry("pv8", 512)["smem_bytes"] == (
        1024 + 64 * 512 * 2 + 2 * (64 * 512 * 2 + 128 * 128) + 128)
    # S = 40: one 64-column chunk; 48 v8 rows (N = 40 is not an s8 wgmma shape)
    geo = tfa.wgmma_geometry("pv8", 40)
    assert geo["cols"] == 48 and geo["splits"] == 1
    assert geo["smem_bytes"] == 1024 + 128 * 64 * 2 + 2 * (64 * 64 * 2 + 48 * 128) + 128
    # the v8 operand's rows are whole s8 wgmma N slices (multiples of 16 up
    # to 256), and its tiles stay 1024-byte aligned (the swizzle's period)
    for s in HEAD_DIMS:
        g = tfa.wgmma_geometry("pv8", s)
        assert g["cols"] % 16 == 0 and g["cols"] * tfa.V8_TILE_KEYS % 1024 == 0
        assert tfa.v8_layout(s, 1000) == (g["splits"] * g["cols"], 1024)
    assert tfa.v8_layout(64, 1000) is None


@pytest.mark.parametrize("kind,shape,grid", [
    ("fwd", (3, 1024, 1024, 1, 512), (16, 3, 4)),   # the VQ AE step: 192 CTAs
    ("fwd", (2, 1024, 1024, 1, 512), (16, 2, 4)),
    ("fwd", (4, 1024, 1024, 8, 40), (8, 32, 1)),    # U-Net level 0
    ("fwd", (4, 16, 16, 8, 160), (1, 32, 1)),
    ("dq", (8, 1024, 1024, 8, 40), (8, 64, 1)),
    ("dq", (8, 64, 64, 8, 160), (1, 64, 1)),
    ("dq", (3, 1024, 1024, 1, 512), (16, 3, 4)),
    ("dkv", (8, 1024, 1024, 8, 40), (8, 64, 1)),
    ("dkv", (8, 256, 256, 8, 80), (2, 64, 1)),
    ("dkv", (8, 64, 64, 8, 160), (1, 64, 1)),
    ("dkv", (4, 1000, 999, 1, 512), (16, 4, 4)),
    ("pv8", (8, 1024, 1024, 8, 40), (8, 64, 1)),    # the int8 U-Net's level 0
    ("pv8", (4, 1024, 1024, 1, 512), (16, 4, 4)),   # the serve decode's head
    ("pv8", (2, 256, 256, 8, 80), (2, 16, 1)),
    ("pv8", (2, 64, 64, 8, 160), (1, 16, 1)),
])
def test_blocks_per_shape(kind, shape, grid):
    b, tq, tk, h, s = shape
    assert tfa.wgmma_geometry(kind, s, b, tq, tk, h)["grid"] == grid


def test_geometry_argument_only_for_bf16_at_the_models_head_dims():
    def arg(dtype, s):
        q = torch.zeros(1, 4, 1, s, dtype=dtype)
        return tfa._geometry_arg("fwd", q)

    assert arg(torch.float32, 40) is None
    assert arg(torch.bfloat16, 64) is None
    assert arg(torch.bfloat16, 36) is None
    got = arg(torch.bfloat16, 512)
    assert isinstance(got, ctypes.Array)
    want = tfa.wgmma_geometry("fwd", 512)
    assert list(got) == [want[k] for k in ("rows", "tile", "cols", "stages", "smem_bytes",
                                           "ctas_per_sm")]
    assert tfa.wgmma_geometry("fwd", 64) is None and tfa.wgmma_geometry("bogus", 40) is None
    pv8 = tfa._geometry_arg("pv8", torch.zeros(1, 4, 1, 40, dtype=torch.bfloat16))
    assert list(pv8)[:3] == [128, 64, 48]


def test_cpu_tensors_count_no_path():
    wrappers = (tfa.flash_attention, tfa.flash_backward_dq, tfa.flash_backward_dkv,
                tfa.flash_attention_pv_int8)
    before = [dict(w.launches_by_path) for w in wrappers]
    q = torch.randn(1, 8, 1, 40, dtype=torch.bfloat16, requires_grad=True)
    tfa.flash_attention(q, q, q, 0.1).float().sum().backward()
    tfa.flash_attention_pv_int8(q.detach(), q.detach(), q.detach(), 0.1)
    after = [w.launches_by_path for w in wrappers]
    assert after == before
    assert set(after[0]) == set(tfa.PATHS) == {"wgmma", "mma.sync", "fma"}
