"""The W8A8 FFN's cluster plan (``ops/fused_ffn.py::ffn8_plan``) and a CPU
mirror of the kernel's walk (``csrc/fused_ffn_int8.cu``), on the CPU.

The plan is checked at every ``chip_smoke.FFN8_SHAPES`` shape, at ragged
row counts, at every width d = 32 .. 1280 the kernel takes (F = 4d) and at
F that are not 4d: a valid cluster size, shared memory within a CTA's 227
KB (worked out by hand for two shapes), every hidden column owned by one
rank, every output column finished by one rank.  The mirror splits the
hidden row into the ranks' slices, max-combines their partial row maxima
in rank order, quantizes each slice, and sums the down-projection's s32
products per output tile over K chunks taken by the two warpgroups in turn
(route (b): every rank reads the whole of u8); it is bit-equal to ``_plain_ffn_int8`` (integer sums and a max
are exact in any order), and within ``TOL`` of the JAX package's
``_pallas_ffn_int8`` in interpret mode, as ``tests/test_torch_int8_ffn.py``
holds the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ldm_tf2_tpu.ops import fused_ffn as jff
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops.quant_conv import quantize_activations

TOL = {"float32": 1e-3, "bfloat16": 5e-3}
PORTABLE = (1, 2, 4, 8)


def _owners(plan, f):
    """Hidden column -> the rank that owns it (each exactly once)."""
    hidden = np.full(plan["tiles"] * tff.FFN8_HB, -1)
    for r in range(plan["cluster"]):
        lo = r * plan["tpr"] * tff.FFN8_HB
        hi = min((r + 1) * plan["tpr"], plan["tiles"]) * tff.FFN8_HB
        assert (hidden[lo:hi] == -1).all()
        hidden[lo:hi] = r
    return hidden[:f]


def _check_plan(m, d, f):
    plan = tff.ffn8_plan(m, d, f)
    c = plan["cluster"]
    portable_fits = [k for k in PORTABLE if k <= plan["tiles"]
                     and tff._ffn8_layout(d, f, k, True)["stages"] >= 2]
    assert c in PORTABLE or (c == 16 and not portable_fits)
    assert c <= plan["tiles"] == -(-f // 64)
    assert plan["row_tiles"] == -(-m // 64) and plan["grid"] == (c * plan["row_tiles"],)
    assert 2 <= plan["stages"] <= tff.FFN8_MAX_STAGES and plan["stages"] % 2 == 0
    assert plan["smem"] <= 232448
    assert plan["smem"] == (1024 + plan["stages"] * (16384 + 16) + plan["y_bytes"]
                            + plan["u_bytes"] + 1280 + 12 * 16)
    assert plan["y_bytes"] == 64 * -(-d // 128) * 128  # y8 in 128-k chunks
    if plan["resident"]:
        assert plan["u_bytes"] >= plan["tpr"] * 64 * 64 * 4 and plan["spill_floats"] == 0
    else:
        assert plan["spill_floats"] == plan["grid"][0] * plan["tpr"] * 64 * 64
    assert plan["u_bytes"] >= 64 * 80 * 4  # a down tile's s32 exchange
    owners = _owners(plan, f)
    assert (owners >= 0).all()  # every hidden column has exactly one owner
    out = np.full(d, -1)
    for i in range(plan["out_tiles"]):  # output tile i is finished by rank i % c
        lo, hi = i * tff.FFN8_BN, min(d, (i + 1) * tff.FFN8_BN)
        assert (out[lo:hi] == -1).all()
        out[lo:hi] = i % c
    assert (out >= 0).all()
    return plan


@pytest.mark.parametrize("m,d", chip_smoke.FFN8_SHAPES + [(1000, 640), (70, 1280), (130, 320),
                                                          (1, 640)])
def test_plan_at_the_kernel_phase_shapes(m, d):
    plan = _check_plan(m, d, 4 * d)
    assert plan["resident"]
    c, rows = plan["cluster"], plan["row_tiles"]
    # the smallest fitting cluster that gives 64 CTAs (else the largest)
    smaller = tff._ffn8_layout(d, 4 * d, c // 2, True)["stages"] >= 2 if c > 1 else False
    assert rows * c >= tff.FFN8_MIN_CTAS or c in (8, 16) or plan["tiles"] < 2 * c
    assert not (smaller and rows * (c // 2) >= tff.FFN8_MIN_CTAS)


def test_shared_bytes_by_hand():
    # [8192, 320]: 20 hidden tiles over 2 ranks (128 row tiles x 2 CTAs),
    # 10 each; y8 3 chunks x 8 KB; u 10 x 16 KB; 1280 bytes of row scales
    # and maxima, 192 of down-slot barriers; 2 slots of 16 KB and 16 bytes
    # of barriers, 8736 bytes to spare
    plan = tff.ffn8_plan(8192, 320, 1280)
    assert (plan["cluster"], plan["tpr"], plan["stages"]) == (2, 10, 2)
    assert (plan["y_bytes"], plan["u_bytes"]) == (24576, 163840)
    assert plan["smem"] == 1024 + 24576 + 163840 + 1280 + 192 + 2 * 16400 == 223712
    assert 232448 - plan["smem"] == 8736
    # [512, 1280]: 80 tiles need 16 ranks (at 8, u alone is 160 KB beside
    # 80 KB of y8); y8 10 chunks x 8 KB; 4 slots leave 512 bytes
    plan = tff.ffn8_plan(512, 1280, 5120)
    assert (plan["cluster"], plan["tpr"], plan["stages"]) == (16, 5, 4)
    assert (plan["y_bytes"], plan["u_bytes"]) == (81920, 81920)
    assert plan["smem"] == 1024 + 81920 + 81920 + 1280 + 192 + 4 * 16400 == 231936
    assert 232448 - plan["smem"] == 512


@pytest.mark.parametrize("d", range(32, 1281, 32))
def test_plan_takes_every_width(d):
    _check_plan(512, d, 4 * d)
    _check_plan(1000, d, 4 * d)


@pytest.mark.parametrize("m,d,f", [(300, 96, 352), (130, 32, 32), (64, 1280, 1024),
                                   (256, 1280, 8192), (64, 1280, 36864)])
def test_plan_takes_other_hidden_widths(m, d, f):
    plan = _check_plan(m, d, f)
    assert plan["resident"] == (f < 8192)  # beyond 16 ranks' shared memory u spills


def test_plan_refuses_what_the_kernel_does_not_take():
    for m, d, f in [(64, 48, 192), (64, 1312, 5248), (64, 64, 200), (0, 64, 256)]:
        with pytest.raises(ValueError):
            tff.ffn8_plan(m, d, f)


def _mirror(x, ln_scale, ln_bias, q, b1v, b1g, b2, plan, eps=1e-5):
    """The kernel's walk in plain PyTorch: the plain LN and y8; each rank's
    slice of hidden tiles (columns past F zero); the partial row maxima
    max-combined in rank order; each slice quantized; output tile i of 80
    columns, finished by rank i % c, summed over K chunks of 128, chunk k
    into warpgroup k % 2's s32 sum, the two added; the plain epilogue."""
    b, t, d = x.shape
    f = q.w1v8.shape[0]
    xf = x.reshape(b * t, d).float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * ln_scale.float() + ln_bias.float()
    y8, sy = quantize_activations(y, -1)
    c, tpr = plan["cluster"], plan["tpr"]
    u = torch.zeros(b * t, plan["tiles"] * 64)
    amax = None
    for r in range(c):
        lo, hi = min(f, r * tpr * 64), min(f, (r + 1) * tpr * 64)
        part = torch.zeros(b * t)
        if lo < hi:
            a = tff._s8_product(y8, q.w1v8[lo:hi]) * (sy * q.s1v[lo:hi]) + b1v[lo:hi].float()
            g = tff._s8_product(y8, q.w1g8[lo:hi]) * (sy * q.s1g[lo:hi]) + b1g[lo:hi].float()
            u[:, lo:hi] = a * tff.gelu_poly(g)
            part = u[:, lo:hi].abs().amax(dim=-1)
        amax = part if amax is None else torch.maximum(amax, part)
    su = torch.clamp(amax, min=1e-8)[:, None] * (1.0 / 127.0)
    u8 = torch.clamp(torch.round(u * (1.0 / su)), -127.0, 127.0)
    acc = torch.zeros(b * t, d, dtype=torch.float64)
    for i in range(plan["out_tiles"]):
        n0, n1 = i * 80, min(d, (i + 1) * 80)
        sums = [torch.zeros(b * t, n1 - n0, dtype=torch.float64) for _ in range(2)]
        for kc in range(plan["k_chunks"]):
            k0, k1 = kc * 128, min(f, (kc + 1) * 128)
            if k0 < k1:
                sums[kc % 2] += u8[:, k0:k1].double() @ q.w28[n0:n1, k0:k1].double().T
        acc[:, n0:n1] = sums[0] + sums[1]
    out = (acc.float() * (su * q.s2)).to(x.dtype) + b2.to(x.dtype) + x.reshape(b * t, d)
    return out.reshape(b, t, d)


def _inputs(m, d, f, dtype, seed):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    x = arr(1, m, d).to(dtype)
    lns, lnb = arr(d, scale=0.1, shift=1.0), arr(d, scale=0.1)
    w1v, w1g = arr(d, f, scale=d**-0.5).to(dtype), arr(d, f, scale=d**-0.5).to(dtype)
    w2 = arr(f, d, scale=f**-0.5).to(dtype)
    b1v, b1g, b2 = arr(f, scale=0.1).to(dtype), arr(f, scale=0.1).to(dtype), arr(d, scale=0.1)
    return x, lns, lnb, tff.quantize_ffn_weights(w1v, w1g, w2), b1v, b1g, b2.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,cluster", [(200, 96, 384, None), (130, 64, 352, None),
                                           (70, 160, 640, 16), (64, 32, 96, None),
                                           (96, 320, 1280, 4)])
def test_mirror_is_bit_equal_to_the_plain_version(dtype, m, d, f, cluster):
    """At the plan's cluster, or a forced one (16 ranks of 1 tile at d =
    160, the largest cluster), ragged M, F % 64 == 32, a single rank."""
    args = _inputs(m, d, f, dtype, seed=m + d)
    plan = tff.ffn8_plan(m, d, f, dtype)
    if cluster is not None:
        plan = dict(plan, **tff._ffn8_layout(d, f, cluster, True))
    got = _mirror(*args, plan)
    want = tff._plain_ffn_int8(*args)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_matches_jax_interpret(dtype):
    """The same numpy inputs through the JAX ``_pallas_ffn_int8`` (interpret
    mode) and the mirror: the LayerNorm's summation order flips a code in a
    few rows, as for the plain version (``tests/test_torch_int8_ffn.py``)."""
    rng = np.random.default_rng(7)
    d, f = 128, 512
    inp = dict(
        x=rng.standard_normal((1, 256, d)).astype(np.float32),
        lns=(rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        lnb=(rng.standard_normal(d) * 0.1).astype(np.float32),
        w1v=(rng.standard_normal((d, f)) * d**-0.5).astype(np.float32),
        b1v=np.linspace(-0.1, 0.1, f, dtype=np.float32),
        w1g=(rng.standard_normal((d, f)) * d**-0.5).astype(np.float32),
        b1g=np.linspace(0.1, -0.1, f, dtype=np.float32),
        w2=(rng.standard_normal((f, d)) * f**-0.5).astype(np.float32),
        b2=np.linspace(-0.1, 0.1, d, dtype=np.float32),
    )
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    act = ("x", "w1v", "b1v", "w1g", "b1g", "w2", "b2")
    j = {k: jnp.asarray(v, jdt if k in act else jnp.float32) for k, v in inp.items()}
    want = jff._pallas_ffn_int8(j["x"], j["lns"], j["lnb"], j["w1v"], j["b1v"], j["w1g"],
                                j["b1g"], j["w2"], j["b2"], 1e-5)
    t = {k: torch.as_tensor(v).to(tdt if k in act else torch.float32) for k, v in inp.items()}
    q = tff.quantize_ffn_weights(t["w1v"], t["w1g"], t["w2"])
    got = _mirror(t["x"], t["lns"], t["lnb"], q, t["b1v"], t["b1g"], t["b2"],
                  tff.ffn8_plan(256, d, f, tdt))
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL[dtype]
