"""The port's opt-in kernels (GroupNorm, GroupNorm stats, the GN+SiLU+3x3
conv chain, short-kv cross-attention) against the JAX package's Pallas
kernels, and the three switches that reach them.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode, as its own tests do
(``tests/test_group_norm.py``, ``tests/test_fused_conv.py``,
``tests/test_cross_attention.py``).  Inputs are seeded numpy arrays.
Tolerances: float32 rtol = atol = 2e-5 (summation order only); bfloat16 at
the JAX tests' own 2e-2, or two bf16 steps of the output's largest
magnitude where the output is a 3x3 conv's.  Every JAX and port switch a
test sets is restored in ``finally``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.ops import cross_attention as jca
from ldm_tf2_tpu.ops import fused_conv as jfc
from ldm_tf2_tpu.ops import group_norm as jgn
from ldm_tf2_tpu.ops.flash_attention import lane_pad
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import attention as tattn
from ldm_tf2_tpu_torch.ops import cross_attention as tca
from ldm_tf2_tpu_torch.ops import fused_conv as tfc
from ldm_tf2_tpu_torch.ops import group_norm as tgn

F32 = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool slows this file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _gn_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (_randn(rng, *shape, scale=2.0, shift=0.3),
            _randn(rng, c, scale=0.1, shift=1.0), _randn(rng, c, scale=0.1))


# ----------------------------------------------------- rows 5-6: GroupNorm --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups,activate", [
    ((2, 8, 8, 128), 32, False), ((2, 8, 8, 128), 32, True),
    ((1, 16, 16, 320), 32, True), ((2, 4, 4, 64), 16, False),
])
def test_group_norm_plain_matches_pallas_gn_kernel(dtype, shape, groups, activate):
    x, gamma, beta = _gn_inputs(0, shape)
    jx, tx = _pair(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jgn._pallas_group_norm(jx, jnp.asarray(gamma), jnp.asarray(beta),
                                      groups, 1e-5, activate)
    got = tgn.group_norm_fused(tx, torch.from_numpy(gamma), torch.from_numpy(beta),
                               groups, 1e-5, activate)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,activate", [
    ((2, 64, 1, 128), True), ((1, 2048, 1, 256), False), ((2, 32, 32, 320), True),
])
def test_group_stats_plain_matches_pallas_stats_kernel(dtype, shape, activate):
    x, gamma, beta = _gn_inputs(1, shape)
    jx, tx = _pair(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        jmean, jrstd = jgn._pallas_group_stats(jx, 32, 1e-5)
        want = jgn._stats_hybrid_group_norm(jx, jnp.asarray(gamma), jnp.asarray(beta),
                                            32, 1e-5, activate)
    mean, rstd = tgn.group_stats(tx, 32, 1e-5)
    assert mean.shape == rstd.shape == (shape[0], shape[-1])
    np.testing.assert_allclose(_np(mean), _np(jmean), **F32)
    np.testing.assert_allclose(_np(rstd), _np(jrstd), **F32)
    tgn.set_groupnorm_impl("stats")
    try:
        got = tgn.group_norm(tx, torch.from_numpy(gamma), torch.from_numpy(beta),
                             32, 1e-5, activate)
    finally:
        tgn.set_groupnorm_impl("auto")
    _close(got, want, dtype)


@pytest.mark.parametrize("impl", ["pallas", "stats"])
def test_group_norm_gradients_match_jax_custom_vjp(impl):
    x, gamma, beta = _gn_inputs(2, (2, 8, 8, 128))
    cot = _randn(np.random.default_rng(3), 2, 8, 8, 128)

    def jloss(x, gamma, beta):
        jgn.set_groupnorm_impl(impl)
        try:
            return jnp.sum(jgn.group_norm(x, gamma, beta, 32, 1e-5, True) * cot)
        finally:
            jgn.set_groupnorm_impl("auto")

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, gamma, beta)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    tgn.set_groupnorm_impl(impl)
    try:
        out = tgn.group_norm(*args, 32, 1e-5, True)
    finally:
        tgn.set_groupnorm_impl("auto")
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


# ------------------------------------------------- row 7: the fused chain --

def _chain_inputs(seed, b, h, w, cin, cout, t, add):
    rng = np.random.default_rng(seed)
    x = _randn(rng, b, h, w, cin)
    gamma = _randn(rng, cin, scale=0.1, shift=1.0)
    beta = _randn(rng, cin, scale=0.1)
    wk = _randn(rng, 3, 3, cin, cout, scale=0.05)  # HWIO, the JAX layout
    bias = _randn(rng, cout, scale=0.1)
    ta = _randn(rng, b, cout) if t else None
    ra = _randn(rng, b, h, w, cout) if add else None
    return x, gamma, beta, wk, bias, ta, ra


def _oihw(wk):
    return torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout,t,add", [
    (2, 16, 16, 64, 64, True, False), (2, 16, 16, 64, 128, False, True),
    (1, 8, 16, 32, 64, True, True), (1, 8, 8, 64, 32, False, False),
])
def test_chain_plain_matches_pallas_fused_kernel(dtype, b, h, w, cin, cout, t, add):
    x, gamma, beta, wk, bias, ta, ra = _chain_inputs(4, b, h, w, cin, cout, t, add)
    jx, tx = _pair(x, dtype)
    jt, tt = _pair(ta, dtype) if t else (None, None)
    jr, tr = _pair(ra, dtype) if add else (None, None)
    want = jfc._fused(jx, jnp.asarray(gamma), jnp.asarray(beta),
                      jnp.asarray(wk).astype(jx.dtype), jnp.asarray(bias), jt, jr,
                      32, 1e-5)  # interpret mode off the TPU
    got = tfc.gn_silu_conv3x3_fused(tx, torch.from_numpy(gamma), torch.from_numpy(beta),
                                    _oihw(wk), torch.from_numpy(bias), time_add=tt,
                                    residual_add=tr)
    assert got.dtype == tx.dtype and got.shape == (b, h, w, cout)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:  # two bf16 steps at the output's largest magnitude
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(_np(got) - _np(want)).max()) <= 2.0**-6 * scale


@pytest.mark.parametrize("t,add", [(True, True), (False, False)])
def test_chain_gradients_match_jax_custom_vjp(t, add):
    x, gamma, beta, wk, bias, ta, ra = _chain_inputs(5, 1, 8, 16, 32, 64, t, add)
    cot = _randn(np.random.default_rng(6), 1, 8, 16, 64)
    extras = [a for a in (ta, ra) if a is not None]

    def jloss(x, gamma, beta, wk, bias, *extra):
        it = iter(extra)
        out = jfc._fused(x, gamma, beta, wk, bias, next(it) if t else None,
                         next(it) if add else None, 32, 1e-5)
        return jnp.sum(out * cot)

    jargs = [jnp.asarray(a) for a in (x, gamma, beta, wk, bias, *extras)]
    want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
             for a in (x, gamma, beta, wk.transpose(3, 2, 0, 1), bias, *extras)]
    it = iter(targs[5:])
    out = tfc.gn_silu_conv3x3_fused(*targs[:5], time_add=next(it) if t else None,
                                    residual_add=next(it) if add else None)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), targs)
    got = [g.numpy() for g in got]
    got[3] = got[3].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    for name, g, w in zip("x gamma beta w bias t residual".split(), got, want):
        scale = float(np.abs(np.asarray(w)).max())
        assert float(np.abs(g - np.asarray(w)).max()) <= 1e-5 * max(scale, 1.0), name


# ------------------------------------- the clamped and unclamped variances --

# Two f32 values whose fast variance E[x^2] - mean^2 rounds to -1.0 in
# float32, in any summation order: two elements make one addition each, and
# the scale by 2^10 keeps every rounding.  (True variance: about 0.107.)  With
# eps = 4, rows 5-6 (unclamped) normalize by rsqrt(3), row 7 (clamped) by
# rsqrt(4): the two rules give materially different results.
_PAIR = np.array([2.828951120376587, 2.828312635421753], np.float32) * np.float32(1024)
_EPS = 4.0


def _near_constant_input(c=64):
    x = np.empty((1, 1, 2, c), np.float32)
    x[0, 0, :, :] = _PAIR[:, None]
    return x


def test_near_constant_group_variance_is_clamped_only_in_the_chain():
    x = _near_constant_input()
    s1 = np.float32(x[0, 0, 0, 0]) + np.float32(x[0, 0, 1, 0])
    s2 = np.float32(x[0, 0, 0, 0] ** 2) + np.float32(x[0, 0, 1, 0] ** 2)
    mean = s1 / np.float32(2)
    assert s2 / np.float32(2) - mean * mean == np.float32(-1.0)
    gamma, beta = np.ones(64, np.float32), np.zeros(64, np.float32)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    jx, jg, jb = (jnp.asarray(a) for a in (x, gamma, beta))

    # rows 5-6 follow the unclamped variance: rstd = rsqrt(-1 + 4)
    _, rstd = tgn.group_stats(tx, 32, _EPS)
    np.testing.assert_allclose(rstd.numpy(), 3.0**-0.5, rtol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        _, jrstd = jgn._pallas_group_stats(jx, 32, _EPS)
        jy = jgn._pallas_group_norm(jx, jg, jb, 32, _EPS, False)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **F32)
    y = tgn.group_norm_fused(tx, tg, tb, 32, _EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)

    # row 7 clamps: the chain's normalized input is (x - mean) * rsqrt(0 + 4)
    wk = np.zeros((3, 3, 64, 64), np.float32)
    wk[1, 1] = np.eye(64, dtype=np.float32)  # the identity conv
    want = jfc._fused(jx, jg, jb, jnp.asarray(wk), jnp.zeros(64), None, None, 32, _EPS)
    got = tfc.gn_silu_conv3x3_fused(tx, tg, tb, _oihw(wk), torch.zeros(64), eps=_EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    d = float(x[0, 0, 0, 0] - x[0, 0, 1, 0]) / 2.0
    silu = lambda v: v / (1.0 + np.exp(-v))
    np.testing.assert_allclose(got.numpy()[0, 0, 0, 0], silu(d * 0.5), rtol=1e-4)
    assert abs(silu(d * 0.5) - silu(d * 3.0**-0.5)) > 1e-2  # the rules differ


# -------------------------------------------- row 12: short-kv attention --

def _flat(a, h, sp):
    """[B, T, H, S] -> the JAX packed flat layout [B, T, H * Sp], each head
    zero-padded to Sp lanes."""
    s = a.shape[-1]
    a = jnp.pad(a, ((0, 0), (0, 0), (0, 0), (0, sp - s)))
    return a.reshape(a.shape[0], a.shape[1], h * sp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,kv,h,s", [
    (2, 256, 77, 2, 40), (1, 64, 77, 2, 80), (1, 16, 77, 1, 160), (2, 32, 33, 2, 64),
])
def test_cross_plain_matches_pallas_cross_kernel(dtype, b, t, kv, h, s):
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, b, n, h, s) for n in (t, kv, kv))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    sp = lane_pad(s)
    want = jca.cross_attention_flat(_flat(jq, h, sp), _flat(jk, h, sp),
                                    _flat(jv, h, sp), s**-0.5, h)
    want = want.reshape(b, t, h, sp)[..., :s]
    got = tca.cross_attention(tq, tk, tv, s**-0.5)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)


def test_cross_gradients_match_jax_custom_vjp():
    b, t, kv, h, s = 2, 64, 77, 2, 40
    rng = np.random.default_rng(8)
    q, k, v, cot = (_randn(rng, b, n, h, s) for n in (t, kv, kv, t))
    sp = lane_pad(s)

    def jloss(q, k, v):
        out = jca.cross_attention_flat(_flat(q, h, sp), _flat(k, h, sp),
                                       _flat(v, h, sp), s**-0.5, h)
        return jnp.sum(out.reshape(b, t, h, sp)[..., :s] * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tca.cross_attention(*args, s**-0.5)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ switches and gates --

def test_switches_keep_the_jax_names_and_values():
    for set_impl, get_impl, good, xla_only in (
        (tgn.set_groupnorm_impl, tgn.get_groupnorm_impl,
         ("auto", "xla", "pallas", "stats"), ("mxu", "barrier", "dotstats")),
        (tfc.set_fused_conv_impl, tfc.get_fused_conv_impl,
         ("auto", "xla", "pallas"), ("dots", "dots3")),
    ):
        try:
            for value in good:
                set_impl(value)
                assert get_impl() == value
            for value in xla_only + ("bogus",):
                with pytest.raises(ValueError, match=value):
                    set_impl(value)
                assert get_impl() == good[-1]  # a refused value changes nothing
        finally:
            set_impl("auto")
    assert tgn.get_groupnorm_impl() == "auto" and tfc.get_fused_conv_impl() == "auto"
    assert not tattn._PACKED_CROSS_ENABLED  # off by default, as in the JAX package
    try:
        tattn.set_packed_cross(True)
        assert tattn.use_packed_cross(1024, 77, 40)
        assert not tattn.use_packed_cross(1024, 129, 40)
    finally:
        tattn.set_packed_cross(False)
    assert not tattn.use_packed_cross(1024, 77, 40)


def test_gates_are_functions_of_shape():
    # every GroupNorm and chain of the north-star U-Net (CFG batch 4) and of
    # the KL autoencoder at 256^2, and every 77-token cross-attention
    for c, hw in ((320, 32), (640, 16), (1280, 8), (128, 256), (256, 128),
                  (512, 64), (512, 32)):
        assert tgn.kernel_takes((4, hw, hw, c))
    for cin, cout, hw in ((320, 320, 32), (640, 320, 32), (960, 640, 16),
                          (2560, 1280, 4), (1920, 1280, 8), (1280, 1280, 4),
                          (256, 128, 256), (512, 256, 128), (512, 512, 32),
                          (128, 128, 256)):
        assert tfc.kernel_takes((2, hw, hw, cin), cout)
    for q_len, s in ((1024, 40), (256, 80), (64, 160), (16, 160)):
        assert tca.kernel_takes(q_len, 77, s)
    # and what they refuse
    assert not tgn.kernel_takes((4, 8, 8, 100))          # partial groups
    assert not tgn.kernel_takes((4, 64))                 # no spatial axis
    assert not tfc.kernel_takes((2, 8, 8, 48), 64)       # 48 % 32 != 0
    assert tfc.kernel_takes((2, 8, 8, 48), 64, num_groups=16)
    assert not tca.kernel_takes(64, 129, 40)             # kv past one tile
    assert not tca.kernel_takes(64, 77, 192)             # head past 160
    assert not tca.kernel_takes(64, 0, 40)
    # the chain's split-K rule: 1 where the 64 x 64 output tiles fill the
    # card twice over, more at the U-Net's deep levels, never more than the
    # 32-channel blocks
    assert tfc.conv_splits(4 * 32 * 32, 320, 320) == 1      # 320 tiles
    assert tfc.conv_splits(4 * 16 * 16, 640, 640) == 2      # 160 tiles
    assert tfc.conv_splits(4 * 4 * 4, 2560, 1280) == 14     # 20 tiles
    assert tfc.conv_splits(4 * 4 * 4, 64, 1280) == 2        # capped by the blocks
    assert tfc.conv_splits(4 * 4 * 4, 48, 1280) == 1        # the FMA path


def test_chain_group_norm_is_not_moved_by_the_groupnorm_switch():
    x, gamma, beta, wk, bias, ta, ra = _chain_inputs(9, 2, 8, 8, 64, 64, True, True)
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
            _oihw(wk), torch.from_numpy(bias))
    kw = dict(time_add=torch.from_numpy(ta), residual_add=torch.from_numpy(ra))
    outs = {}
    try:
        for conv in ("auto", "pallas"):
            tfc.set_fused_conv_impl(conv)
            for gn in ("auto", "xla", "pallas", "stats"):
                tgn.set_groupnorm_impl(gn)
                outs[conv, gn] = tfc.gn_silu_conv3x3(*args, **kw)
    finally:
        tgn.set_groupnorm_impl("auto")
        tfc.set_fused_conv_impl("auto")
    for (conv, gn), out in outs.items():
        assert torch.equal(out, outs[conv, "auto"]), (conv, gn)
    # the chain's statistics are the clamped ones of the "auto" GroupNorm
    y = tgn._mxu_group_norm(args[0], args[1], args[2], 32, 1e-5, True)
    want = tfc.conv3x3(y, args[3], args[4]) + kw["time_add"][:, None, None] \
        + kw["residual_add"]
    assert torch.equal(outs["auto", "auto"], want)


_TINY = dict(model_channels=64, out_channels=4, num_blocks=1, channel_mult=(1, 2),
             num_heads=2, context_channels=64, dropout_rate=0.0)


def _tiny_unet_io():
    rng = np.random.default_rng(10)
    x = _randn(rng, 2, 16, 16, 4)
    t = np.array([981.0, 21.0], np.float32)
    ctx = _randn(rng, 2, 77, 64)
    jax_model = jm.UNet(**_TINY)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), x, t, ctx))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = gu.materialize(zeros, gu.unet_order(1, (1, 2)), gu.SEED)
    return jax_model, variables, (x, t, ctx)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_tiny_unet_with_the_kernels_on_matches_jax(monkeypatch):
    """Both switches on "pallas" on both sides: JAX's gates claim the level-0
    (16x16) chains and every GroupNorm, run in interpret mode; the port's
    take every chain, GroupNorm and, with packed cross on, every
    cross-attention (JAX cannot reach its cross kernel off a TPU; row 12 is
    held by its own tests above).  float32 on both sides, within 1e-5."""
    jax_model, variables, (x, t, ctx) = _tiny_unet_io()
    jgn.set_groupnorm_impl("pallas")
    jfc.set_fused_conv_impl("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax.jit(jax_model.apply)(variables, x, t, ctx))
    finally:
        jgn.set_groupnorm_impl("auto")
        jfc.set_fused_conv_impl("auto")
    model = load_params(tm.UNet(**_TINY), variables)
    inputs = [torch.from_numpy(a) for a in (x, t, ctx)]
    with torch.no_grad():
        plain = model(*inputs).numpy()
    calls = {}
    _spy(monkeypatch, tgn, "group_norm_fused", calls)
    _spy(monkeypatch, tfc, "gn_silu_conv3x3_fused", calls)
    _spy(monkeypatch, tunet, "cross_attention", calls)
    tgn.set_groupnorm_impl("pallas")
    tfc.set_fused_conv_impl("pallas")
    tattn.set_packed_cross(True)
    try:
        with torch.no_grad():
            got = model(*inputs).numpy()
    finally:
        tgn.set_groupnorm_impl("auto")
        tfc.set_fused_conv_impl("auto")
        tattn.set_packed_cross(False)
    # 8 ResBlocks (2 chains each), 4 spatial transformers (a GroupNorm and a
    # cross-attention each) and the head's GroupNorm
    assert calls == {"gn_silu_conv3x3_fused": 16, "group_norm_fused": 5,
                     "cross_attention": 4}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)


def test_auto_routes_take_no_kernel(monkeypatch):
    """With every switch at its default the U-Net and the autoencoder call
    none of the four kernels' wrappers, and group_norm is the clamped
    "auto" GroupNorm."""
    calls = {}
    for module, name in ((tgn, "group_norm_fused"), (tgn, "group_stats"),
                         (tfc, "gn_silu_conv3x3_fused"), (tunet, "cross_attention")):
        _spy(monkeypatch, module, name, calls)
    _, variables, (x, t, ctx) = _tiny_unet_io()
    model = load_params(tm.UNet(**_TINY), variables)
    ae = tm.AutoencoderKL(channels=32, num_blocks=1, multipliers=(1, 2))
    from ldm_tf2_tpu_torch import factory
    factory.randomize_(ae, seed=0)
    with torch.no_grad():
        model(*(torch.from_numpy(a) for a in (x, t, ctx)))
        ae.decode(torch.zeros(1, 8, 8, 4))
    assert calls == {}
    xs, gamma, beta = (torch.from_numpy(a) for a in _gn_inputs(11, (2, 4, 4, 64)))
    assert torch.equal(tgn.group_norm(xs, gamma, beta),
                       tgn._mxu_group_norm(xs, gamma, beta))


def test_wrappers_refuse_what_their_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 40)
    with pytest.raises(ValueError, match="kv <= 128"):
        tca.cross_attention(q, torch.zeros(1, 129, 2, 40), torch.zeros(1, 129, 2, 40), 0.1)
    with pytest.raises(ValueError, match="does not take"):
        tfc.gn_silu_conv3x3_fused(torch.zeros(1, 4, 4, 48), torch.ones(48), torch.zeros(48),
                                  torch.zeros(8, 48, 3, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="not divisible"):
        tgn.group_norm_fused(torch.zeros(1, 4, 4, 48), torch.ones(48), torch.zeros(48))
    with pytest.raises(TypeError):
        tgn.group_stats(torch.zeros(1, 4, 4, 64, dtype=torch.float64))
