"""The one-launch GroupNorm statistics kernel's grid (``ops/group_norm.py``
``stats_grid``, ``csrc/gn_stats.cuh``): blocks per shape at every shape of
the opt-in main path, in both dtypes, and what every grid must hold (whole
groups per slice, 16-byte loads, a deterministic split).  The kernel runs
only on the card (``tests/test_torch_kernels_cuda.py``)."""

import math

import pytest
import torch

from ldm_tf2_tpu_torch.ops import group_norm as tgn

# The opt-in main path's GroupNorm shapes (chip_smoke.OPT_GN): the spatial
# transformers' at each U-Net level, the decoder's mid-block attention's and
# its last ResBlock's at 256^2
OPT_GN = [(4, 32, 32, 320), (4, 16, 16, 640), (4, 8, 8, 1280), (4, 4, 4, 1280),
          (2, 32, 32, 512), (2, 256, 256, 128)]


def _blocks(b, chunks, gps, groups=32):
    return chunks * -(-groups // gps) * b


@pytest.mark.parametrize("shape,vec,chunks,gps", [
    ((4, 32, 32, 320), 8, 32, 8),      # bf16: 32 chunks x 4 slices of 80 channels
    ((4, 32, 32, 320), 4, 32, 10),     # float32
    ((4, 16, 16, 640), 8, 8, 2),
    ((4, 16, 16, 640), 4, 8, 3),
    ((4, 8, 8, 1280), 8, 2, 1),
    ((4, 4, 4, 1280), 8, 1, 1),        # 16 positions: one chunk, a slice per group
    ((4, 4, 4, 1280), 4, 1, 1),
    ((2, 32, 32, 512), 8, 32, 6),
    ((2, 256, 256, 128), 8, 132, 32),  # the AE's map: 264 chunks fill the card
    ((2, 256, 256, 128), 4, 132, 32),
])
def test_blocks_per_shape(shape, vec, chunks, gps):
    b, c = shape[0], shape[-1]
    assert tgn.stats_grid(b, shape[1] * shape[2], c, 32, vec) == (chunks, gps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", OPT_GN + [(1, 4, 4, 64), (2, 5, 7, 96), (3, 9, 9, 40)])
def test_grid_covers_whole_groups_and_fills_the_card(dtype, shape):
    x = torch.zeros(shape, dtype=dtype)
    b, c = shape[0], shape[-1]
    hw = x.numel() // (b * c)
    vec = tgn.stats_vec(x)
    assert vec == (16 // x.element_size() if c * x.element_size() % 16 == 0 else 1)
    chunks, gps = tgn.stats_grid(b, hw, c, 32, vec)
    cg = c // 32
    # a slice is whole groups and a whole number of loads; at most 256
    # groups (one finishing thread each)
    assert 1 <= gps <= 32 and gps <= 256 and gps * cg % vec == 0
    # chunks of at least 32 positions, no more than needed for the card
    assert chunks == 1 or hw // chunks >= 32
    blocks = _blocks(b, chunks, gps)
    assert blocks <= 2 * tgn.STATS_CTAS
    # a shape that can fill the card does (at 32 positions and one load a
    # slice, the most blocks the shape has)
    most = b * max(1, hw // 32) * (32 // (vec // math.gcd(cg, vec)))
    assert blocks >= min(tgn.STATS_CTAS, most) // 2
    # a function of the shape only: the summation order is fixed per shape
    assert tgn.stats_grid(b, hw, c, 32, vec) == (chunks, gps)


def test_workspace_is_needed_only_across_chunks():
    assert tgn.stats_workspace(torch.device("cpu"), 4, 1, 1, 32) == (None, None)
