"""The GroupNorm cluster kernels' plan (``ops/quant_conv.py``
``gn_cluster_plan``, ``csrc/gn_cluster.cuh``): rows 8 and 9 (GN + SiLU +
int8 codes, a cluster per image) and row 5 (GroupNorm, a cluster per image
and slice of whole groups).

At every shape the serving and opt-in paths give the kernels, the plan must
fit the card (portable clusters, 227 KB of shared memory a CTA), cover each
image's slab exactly once, keep 16-byte loads where the shape allows them,
re-read exactly where a CTA's rows do not fit, and depend on the shape
alone.  A plain-torch mirror of the plan's partition (per-thread sums, the
row phases in order, channels into groups, the ranks in order) is held to
the JAX package's Pallas kernels in interpret mode, at the tolerances of
``tests/test_torch_int8.py`` and ``tests/test_torch_fused_kernels.py``.
The kernels run only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldm_tf2_tpu.ops import group_norm as jgn
from ldm_tf2_tpu.ops import quant_conv as jqc
from ldm_tf2_tpu_torch.ops import group_norm as tgn
from ldm_tf2_tpu_torch.ops import quant_conv as tqc

# chip_smoke.SERVE_CHAINS' distinct inputs, then the map the TPU streams
SERVE = [(8, 8, 8, 640), (8, 8, 8, 1280), (8, 8, 8, 1920), (8, 8, 8, 2560),
         (8, 16, 16, 320), (8, 16, 16, 640), (8, 16, 16, 960), (8, 16, 16, 1280),
         (8, 16, 16, 1920), (8, 32, 32, 320), (8, 32, 32, 640)]
STREAMED = (8, 64, 64, 320)
# chip_smoke.OPT_GN's shapes
OPT_GN = [(4, 32, 32, 320), (4, 16, 16, 640), (4, 8, 8, 1280), (4, 4, 4, 1280),
          (2, 32, 32, 512), (2, 256, 256, 128)]
ODD = [(2, 4, 4, 96), (3, 5, 7, 96), (1, 1, 16, 64), (2, 3, 3, 32), (1, 33, 1, 160)]
CASES = ([(s, torch.bfloat16, True) for s in SERVE + [STREAMED] + ODD]
         + [(SERVE[0], torch.float32, True)]
         + [(s, d, False) for s in OPT_GN + ODD for d in (torch.bfloat16, torch.float32)])
ELEM = {torch.bfloat16: 2, torch.float32: 4}


def _fixed_bytes(p, cw, per_image):
    """The float32 arrays beside the kept rows (gn_cluster.cuh smem_bytes)."""
    return 4 * (2 * p["cols"] * p["phases"] * p["vec"] + (4 if per_image else 2) * cw
                + 4 * p["gps"] + 36)


def _ids(case):
    shape, dtype, per_image = case
    return f"{'x'.join(map(str, shape))}-{str(dtype)[6:]}-{'row8' if per_image else 'row5'}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plan_fits_covers_and_depends_on_the_shape_alone(case):
    shape, dtype, per_image = case
    p = tqc.gn_cluster_plan(shape, dtype, per_image)
    b, c = shape[0], shape[-1]
    hw, cg, elem = math.prod(shape[1:-1]), c // 32, ELEM[dtype]
    cw = p["gps"] * cg
    # portable clusters and a CTA the card can hold; row 5's two to an SM
    budget = tqc.GN_SMEM if per_image else tqc.GN_PAIR_SMEM
    assert p["cluster"] in (1, 2, 4, 8)
    assert p["smem"] <= budget and tqc.GN_SMEM == 227 * 1024
    assert 2 * (tqc.GN_PAIR_SMEM + 1024) <= 228 * 1024
    assert p["threads"] <= (512 if per_image else 256) and p["threads"] % 32 == 0
    assert p["cols"] * p["phases"] <= p["threads"] < p["cols"] * p["phases"] + 32
    assert p["smem"] == -(-p["keep"] * cw * elem // 16) * 16 + _fixed_bytes(p, cw, per_image)
    # rows 8 and 9: one cluster per image over every group; row 5: slices of
    # whole groups
    assert p["gps"] * p["slices"] == 32 and 32 % p["gps"] == 0
    if per_image:
        assert p["slices"] == 1
    assert p["grid"] == (p["cluster"], p["slices"], b)
    # the ranks' rows cover the image's HW rows exactly once, none empty
    spans = [(r * p["rows"], min(hw, (r + 1) * p["rows"])) for r in range(p["cluster"])]
    assert spans[0][0] == 0 and spans[-1][1] == hw
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    # the threads' (row, vector column) pairs cover each CTA's rows x the
    # slice's vectors exactly once
    nv = cw // p["vec"]
    assert nv * p["vec"] == cw and 1 <= p["cols"] <= nv
    if p["rows"] * nv <= 1 << 16:
        seen = [(r, vb + lv) for rp in range(p["phases"]) for lv in range(p["cols"])
                for vb in range(0, nv, p["cols"]) if vb + lv < nv
                for r in range(rp, p["rows"], p["phases"])]
        assert len(seen) == len(set(seen)) == p["rows"] * nv
    # 16-byte loads wherever C and the slice are whole 16-byte runs
    whole = c * elem % 16 == 0 and cw * elem % 16 == 0
    assert (p["vec"] * elem == 16) == whole
    assert p["vec"] == 1 or p["vec"] * elem == 16
    # re-read exactly where the CTA's rows exceed its shared memory
    def need(rows):
        return -(-rows * cw * elem // 16) * 16 + _fixed_bytes(p, cw, per_image)

    fits = need(p["rows"]) <= budget
    assert (p["mode"] == "resident") == fits
    assert (p["keep"] == p["rows"]) == fits and 0 < p["keep"] <= p["rows"]
    if not fits:  # it keeps as many rows as fit
        assert need(p["keep"] + 1) > budget
    # a function of the shape and dtype only
    assert tqc.gn_cluster_plan(torch.Size(shape), dtype, per_image) == p
    assert tqc.gn_cluster_plan(list(shape), dtype, per_image) == p


def test_modes_and_sizes_at_the_path_shapes():
    """Every serving shape runs resident in bf16, the streamed map and the
    autoencoder's 256^2 map re-read; a batch of 4 gets at least 128 CTAs in
    row 5, a batch of 8 clusters of 8 in rows 8 and 9."""
    for s in SERVE:
        p = tqc.gn_cluster_plan(s, torch.bfloat16, True)
        assert (p["mode"], p["cluster"], p["vec"]) == ("resident", 8, 8), s
    assert tqc.gn_cluster_plan(STREAMED, torch.bfloat16, True)["mode"] == "reread"
    for dtype in (torch.bfloat16, torch.float32):
        for s in OPT_GN:
            p = tqc.gn_cluster_plan(s, dtype, False)
            assert p["mode"] == ("reread" if s == (2, 256, 256, 128) else "resident"), s
            assert math.prod(p["grid"]) >= tqc.GN_CTAS, s
    # cg = 10 in bf16: a 16-byte slice needs a multiple of 4 groups
    assert tqc.gn_cluster_plan((4, 32, 32, 320), torch.bfloat16, False)["gps"] % 4 == 0


def test_plan_refuses_what_it_cannot_split():
    with pytest.raises(ValueError):
        tqc.gn_cluster_plan((2, 4, 4, 48), torch.bfloat16, True)


# ------------------------------------------------- the partition's mirror --

def _ordered_sum(t, chunk=8):
    """Sum over dim 1 as ``gn_cluster.cuh::ordered_sums`` adds: the terms in
    chunks of 8 in order, then the chunks in order."""
    total = torch.zeros_like(t[:, 0])
    for k0 in range(0, t.shape[1], chunk):
        part = torch.zeros_like(t[:, 0])
        for k in range(k0, min(k0 + chunk, t.shape[1])):
            part = part + t[:, k]
        total = total + part
    return total


def _mirror_stats(x, plan, num_groups, eps, clamp):
    """Per-group (mean, rstd) [B, G] float32 summed as the kernels sum: each
    thread its rows rp, rp + phases, ... of its CTA in order (x^2 rounded
    before it is added), the row phases and the channels of a group each in
    ``_ordered_sum``'s order, the cluster's ranks in order; then mean = s1 /
    n, var = s2 / n - mean^2 (clamped at 0 where ``clamp``), rstd = 1 /
    sqrt(var + eps)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    hw, cg, gps = xf.shape[1], c // num_groups, plan["gps"]
    cw, phases = gps * cg, plan["phases"]
    s1 = torch.zeros(b, num_groups)
    s2 = torch.zeros(b, num_groups)
    for sl in range(plan["slices"]):
        xs = xf[:, :, sl * cw:(sl + 1) * cw]
        for rank in range(plan["cluster"]):  # ranks in order
            xr = xs[:, rank * plan["rows"]:(rank + 1) * plan["rows"]]
            t1, t2 = torch.zeros(b, phases, cw), torch.zeros(b, phases, cw)
            for k in range(0, xr.shape[1], phases):  # each thread's rows in order
                blk = xr[:, k:k + phases]
                m = blk.shape[1]
                t1[:, :m] = t1[:, :m] + blk
                t2[:, :m] = t2[:, :m] + blk * blk
            c1, c2 = _ordered_sum(t1), _ordered_sum(t2)  # the row phases
            g1 = _ordered_sum(c1.reshape(b, gps, cg).transpose(1, 2))  # channels of a group
            g2 = _ordered_sum(c2.reshape(b, gps, cg).transpose(1, 2))
            s1[:, sl * gps:(sl + 1) * gps] += g1
            s2[:, sl * gps:(sl + 1) * gps] += g2
    n = torch.tensor(float(hw * cg))
    mean = s1 / n
    var = s2 / n - mean * mean
    if clamp:
        var = torch.clamp(var, min=0.0)
    return mean, 1.0 / torch.sqrt(var + eps)


def _mirror_normalize(x, mean, rstd, gamma, beta, num_groups, activate):
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, num_groups, cg)
    factor = rstd[:, None, :, None] * gamma.reshape(num_groups, cg)
    y = (xf - mean[:, None, :, None]) * factor + beta.reshape(num_groups, cg)
    if activate:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.reshape(x.shape)


def _mirror_gn_silu_quant(x, gamma, beta, num_groups=32, eps=1e-5):
    plan = tqc.gn_cluster_plan(tuple(x.shape), x.dtype, True, num_groups)
    mean, rstd = _mirror_stats(x, plan, num_groups, eps, clamp=True)
    y = _mirror_normalize(x, mean, rstd, gamma, beta, num_groups, True)
    b = x.shape[0]
    amax = y.reshape(b, -1).abs().amax(dim=1)
    sa = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    inv = 1.0 / sa
    y8 = torch.clamp(torch.round(torch.clamp(y * inv[:, None, None, None], -127.0, 127.0)),
                     -127.0, 127.0)
    return y8.to(torch.int8), sa


def _mirror_group_norm(x, gamma, beta, num_groups, eps, activate):
    plan = tqc.gn_cluster_plan(tuple(x.shape), x.dtype, False, num_groups)
    mean, rstd = _mirror_stats(x, plan, num_groups, eps, clamp=False)
    return _mirror_normalize(x, mean, rstd, gamma, beta, num_groups, activate).to(x.dtype)


def _randn(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 16, 16, 96), (1, 4, 4, 256)])
def test_mirror_of_rows_8_9_matches_the_jax_kernel(dtype, shape):
    """The plan's partition of the statistics, then y, the amax and the
    codes, against ``_gn_silu_quant_kernel`` (interpret mode): the scale to
    1e-6, codes within one step on at most 1e-3 of them."""
    rng = np.random.default_rng(11)
    c = shape[-1]
    x = _randn(rng, *shape, scale=2.0, shift=0.5)
    gamma, beta = _randn(rng, c, shift=1.0), _randn(rng, c)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    j8, jsa = jqc.gn_silu_quant(jx, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y8, sa = _mirror_gn_silu_quant(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_allclose(sa.numpy(), np.asarray(jsa), rtol=1e-6)
    diff = np.abs(y8.numpy().astype(np.int32) - np.asarray(j8, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # and the port's plain version, which sums in torch's order
    r8, rsa = tqc.gn_silu_quant(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_allclose(sa.numpy(), rsa.numpy(), rtol=1e-6)
    assert int((y8.int() - r8.int()).abs().max()) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,activate", [((2, 8, 8, 128), False), ((2, 8, 8, 128), True),
                                            ((1, 16, 16, 320), True), ((4, 4, 4, 96), False)])
def test_mirror_of_row_5_matches_the_jax_kernel(dtype, shape, activate):
    """The plan's slices and ranks, against ``_gn_kernel`` (interpret mode):
    float32 to 2e-5, bf16 at the JAX tests' 2e-2."""
    rng = np.random.default_rng(12)
    c = shape[-1]
    x = _randn(rng, *shape, scale=2.0, shift=0.3)
    gamma, beta = _randn(rng, c, scale=0.1, shift=1.0), _randn(rng, c, scale=0.1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        want = jgn._pallas_group_norm(jx, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5,
                                      activate)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = _mirror_group_norm(tx, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5,
                             activate)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)
    plain = tgn.group_norm_fused(tx, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5,
                                 activate)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=tol, atol=tol)
