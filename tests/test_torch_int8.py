"""The port's int8 serving modes against the JAX package's.

``tpu.quantize: int8`` (W8A8 ResBlock chains, ``ops/quant_conv.py``) and
``tpu.quantize_attention: int8pv`` (int8 P.V in the flash forward).  The
JAX side runs its Pallas kernels in interpret mode, as its own tests do
(``tests/test_quant_conv.py``, ``tests/test_flash_attention.py``); the
port's wrappers take their plain versions on CPU tensors.  Every JAX
global that a test switches is restored in ``finally``.

Tolerances come from the quantization step.  Both sides compute the same
float32 math in another summation order, so a value that lands within an
ulp of a rounding midpoint can take the neighbouring int8 code: one code
of 127 moves the dequantized value by one step, and such flips are rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.diffusion import sampler as jsampler
from ldm_tf2_tpu.ops import attention as jattn
from ldm_tf2_tpu.ops import flash_attention as jfa
from ldm_tf2_tpu.ops import quant_conv as jqc
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.models import unet as tunet
from ldm_tf2_tpu_torch.ops import flash_attention as tfa
from ldm_tf2_tpu_torch.ops import fused_conv as tfc
from ldm_tf2_tpu_torch.ops import quant_conv as tqc
from ldm_tf2_tpu_torch.ops.attention import dot_product_attention
from ldm_tf2_tpu_torch.ops.flash_attention import (
    flash_attention_pv_int8, jax_block_k,
)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return None if a is None else a.detach().numpy()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _variables(init, order, seed):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


# ----------------------------------------------------------------- modules --

@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax_exactly(stored):
    w = _randn(np.random.default_rng(0), 3, 3, 64, 96, scale=0.05)  # HWIO
    jw = jnp.asarray(w).astype(stored)
    j8, jws = jqc.quantize_weight(jw)
    tw = _t(w.transpose(3, 2, 0, 1)).to(getattr(torch, stored))  # OIHW
    w8, ws = tqc.quantize_weight(tw)
    np.testing.assert_array_equal(w8.numpy().transpose(2, 3, 1, 0), np.asarray(j8))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


@pytest.mark.parametrize("shape", [(2, 8, 8, 64),      # one-pass kernel
                                   (1, 64, 64, 256)])  # streaming kernel
def test_gn_silu_quant_matches_jax(shape):
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = _randn(rng, *shape, scale=2.0) + 0.5
    gamma, beta = _randn(rng, c) + 1.0, _randn(rng, c)
    j8, jsa = jqc.gn_silu_quant(jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta), 32, 1e-5)
    y8, sa = tqc.gn_silu_quant(_t(x), _t(gamma), _t(beta), 32, 1e-5)
    np.testing.assert_allclose(sa.numpy(), np.asarray(jsa), rtol=1e-6)
    diff = np.abs(y8.numpy().astype(np.int32) - np.asarray(j8, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("hw,epilogue", [(16, "t"), (16, "residual"),
                                         (8, "t"), (8, "residual")])
def test_gn_silu_conv3x3_int8_matches_jax(hw, epilogue):
    """hw 16 (256 pixels) is a whole-chain shape on the JAX side
    (``_chain_kernel``), hw 8 a two-stage one (quantize kernel, then the
    s8 conv): the port computes both as its two kernels."""
    rng = np.random.default_rng(2)
    b, cin, cout = 2, 64, 96
    x = _randn(rng, b, hw, hw, cin)
    gamma, beta = _randn(rng, cin) + 1.0, _randn(rng, cin)
    w = _randn(rng, 3, 3, cin, cout, scale=0.05)
    bias = _randn(rng, cout, scale=0.1)
    t = _randn(rng, b, cout) if epilogue == "t" else None
    add = _randn(rng, b, hw, hw, cout) if epilogue == "residual" else None
    assert jqc.use_fused_int8_chain(hw * hw, hw, cin, cout, add is not None) \
        == (hw == 16)
    want = jqc.gn_silu_conv3x3_int8(
        jnp.asarray(x), gamma, beta, jnp.asarray(w), bias,
        time_add=None if t is None else jnp.asarray(t),
        residual_add=None if add is None else jnp.asarray(add))
    w8, ws = tqc.int8_conv_weights(_t(w.transpose(3, 2, 0, 1)))
    got = tqc.gn_silu_conv3x3_int8(
        _t(x), _t(gamma), _t(beta), w8, ws, _t(bias),
        time_add=None if t is None else _t(t),
        residual_add=None if add is None else _t(add))
    assert _rel_l2(got.numpy(), want) <= 1e-4


def _unet_chain_shapes(latent, monkeypatch):
    """([H, W, Cin], Cout, has_residual) of every ResBlock chain that one
    north-star U-Net forward at a latent x latent input runs, from that
    forward on the meta device."""
    chains, tokens = [], []

    def chain(x, gamma, beta, w, b, *, residual_add=None, **kw):
        chains.append((tuple(x.shape[1:]), w.shape[0], residual_add is not None))
        return x.new_empty(*x.shape[:3], w.shape[0])

    def self_attention(q, k, v, scale, pv_int8=False):
        tokens.append(q.shape[1])
        return torch.empty_like(q)

    monkeypatch.setattr(tunet, "gn_silu_conv3x3", chain)
    monkeypatch.setattr(tunet, "spatial_self_attention", self_attention)
    monkeypatch.setattr(tunet, "fused_ffn", lambda x, *weights: torch.empty_like(x))
    with torch.device("meta"):
        tm.UNet()(torch.empty(2, latent, latent, 4), torch.empty(2),
                  torch.empty(2, 77, 1280))
    assert (len(chains), len(tokens)) == (44, 16)
    return chains


def test_int8_gate_matches_jax_on_every_serving_shape(monkeypatch):
    """The north star (256^2: latent 32) and 512^2 (latent 64): the port's
    copy of the gate decides as the JAX package does on every chain; at
    256^2 it quantizes 29 of the 44 chains, 19 of them whole-chain."""
    jqc.set_conv_quant("int8")
    try:
        for latent in (32, 64):
            picked = []
            for (h, w, cin), cout, has_add in _unet_chain_shapes(latent, monkeypatch):
                shape = (8, h, w, cin)
                mine = tqc.use_int8_conv(shape, cout, 32, has_add)
                assert mine == jqc.use_int8_conv(shape, cout, 32, has_add), shape
                assert tqc.use_fused_int8_chain(h * w, w, cin, cout, has_add) \
                    == jqc.use_fused_int8_chain(h * w, w, cin, cout, has_add)
                if mine:
                    picked.append(h * w >= 256)
            if latent == 32:
                assert (len(picked), sum(picked)) == (29, 19)
    finally:
        jqc.set_conv_quant("none")


def test_pv_int8_block_matches_jax_pick():
    for s, kv in ((40, 1024), (40, 1000), (80, 256), (512, 1024), (40, 4096)):
        sp = jfa.lane_pad(s)
        want = min(jfa._pick_blocks(sp, kv)[1], jfa._round_up(kv, 128))
        assert jax_block_k(s, kv) == want, (s, kv)
    assert jax_block_k(40, 1024) == 1024 and jax_block_k(512, 1024) == 512


# p codes step by 1/127 of the row's largest weight and v codes by 1/127 of
# the block's largest |v| (about 4 for these normals): a code that flips
# between the two implementations moves an output by about 4 / 127 / l,
# where l >= 1 sums the row's weights.  1e-3 absolute admits a few such
# flips in a row.  int8 P.V itself is about 2.5e-2 in relative L2 from
# exact attention on these inputs; the two implementations must agree 25x
# closer than that (S = 40 agrees to 1.4e-7, S = 512, whose longer dot
# products flip 0.8% of the outputs, to 1.8e-4).
PV_ATOL, PV_REL_L2 = 1e-3, 1e-3


@pytest.mark.parametrize("b,tq,tk,h,s,route", [
    (1, 1024, 1024, 2, 40, "flat"),    # U-Net level 0: packed flash route
    (1, 1024, 1024, 1, 512, "bthd"),   # autoencoder mid-block attention
    (1, 1000, 1000, 2, 40, "bthd"),    # ragged kv: masked tail block
])
def test_pv_int8_plain_matches_jax(b, tq, tk, h, s, route):
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, b, n, h, s) for n in (tq, tk, tk))
    scale = s**-0.5
    jfa.set_flash_pv_int8(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            if route == "flat":
                sp = jfa.lane_pad(s)

                def flat(a):
                    a = np.pad(a, ((0, 0), (0, 0), (0, 0), (0, sp - s)))
                    return jnp.asarray(a.reshape(b, a.shape[1], h * sp))

                want = np.asarray(jfa.flash_attention_flat(
                    flat(q), flat(k), flat(v), scale, h))
                want = want.reshape(b, tq, h, sp)[..., :s]
            else:
                want = np.asarray(jfa.flash_attention(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    finally:
        jfa.set_flash_pv_int8(False)
    got = flash_attention_pv_int8(_t(q), _t(k), _t(v), scale).numpy()
    assert float(np.abs(got - want).max()) <= PV_ATOL
    assert _rel_l2(got, want) <= PV_REL_L2
    exact = np.asarray(jfa._xla_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale))
    assert float(np.abs(got - exact).max()) > 1e-5  # the quantization ran


def test_int8_wrappers_check_inputs_and_take_no_fallback_off_cpu():
    """A tensor that is not on the CPU never gets the plain version: the
    wrapper launches its kernel or raises."""
    x = torch.zeros(1, 8, 8, 64, device="meta")
    g = torch.ones(64, device="meta")
    with pytest.raises(ValueError):
        tqc.gn_silu_quant(x, g, g)
    with pytest.raises(ValueError):
        tqc.gn_silu_quant(torch.zeros(1, 8, 8, 48), torch.ones(48), torch.ones(48))
    y8 = torch.zeros(1, 8, 8, 64, dtype=torch.int8, device="meta")
    w8 = torch.zeros(32, 3, 3, 64, dtype=torch.int8, device="meta")
    one = torch.ones(1, device="meta")
    with pytest.raises(ValueError):
        tqc.s8_conv3x3(y8, one, w8, torch.ones(32, device="meta"),
                       torch.ones(32, device="meta"))
    with pytest.raises(ValueError):  # w8 not [Cout, 3, 3, Cin]
        tqc.s8_conv3x3(torch.zeros(1, 8, 8, 64, dtype=torch.int8), torch.ones(1),
                       torch.zeros(32, 64, 3, 3, dtype=torch.int8),
                       torch.ones(32), torch.ones(32))
    q = torch.zeros(1, 1024, 2, 40, device="meta")
    with pytest.raises(ValueError):
        flash_attention_pv_int8(q, q, q, 1.0)


# ------------------------------------------------------------------ models --

def test_tiny_unet_int8_matches_jax():
    """A 16x16 latent: level 0 (256 pixels) takes whole chains, level 1
    (8x8) two-stage chains, level 2 (4x4) stays float32."""
    kw = dict(model_channels=32, out_channels=4, num_blocks=1,
              channel_mult=(1, 2, 2), num_heads=2, context_channels=64,
              dropout_rate=0.0)
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 16, 16, 4)
    t = np.array([981.0, 21.0], np.float32)
    ctx = _randn(rng, 2, 5, 64)
    jax_model = jm.UNet(**kw)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), x, t, ctx),
                           gu.unet_order(1, (1, 2, 2)), gu.SEED)
    jqc.set_conv_quant("int8")
    try:
        want = np.asarray(jax.jit(jax_model.apply)(variables, x, t, ctx))
    finally:
        jqc.set_conv_quant("none")
    model = load_params(tm.UNet(**kw), variables)
    model.set_serving_modes(conv_quant=True)
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(ctx)).numpy()
    # float32 on both sides: the codes agree but for rare midpoint flips
    assert _rel_l2(got, want) <= 1e-4
    model.set_serving_modes(conv_quant=False)
    with torch.no_grad():
        plain = model(_t(x), _t(t), _t(ctx)).numpy()
    assert _rel_l2(plain, want) > 1e-3  # the int8 chains ran


SLICE_TR = dict(vocab_size=100, encoder_stack_size=1, hidden_size=64,
                num_heads=2, size_per_head=32, max_seq_len=8, filter_size=128,
                dropout_rate=0.0)
SLICE_UNET = dict(model_channels=32, out_channels=4, num_blocks=1,
                  channel_mult=(1, 2), num_heads=2, context_channels=64,
                  dropout_rate=0.0)
SLICE_AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))


def test_int8_serving_slice_matches_jax(monkeypatch):
    """Text encoder -> 2 CFG DDIM steps at a 32x32 latent (level-0
    self-attention over 1024 tokens, so int8 P.V runs in the U-Net and in
    the autoencoder's mid block) -> KL decode, int8 chains and int8 P.V on,
    per-slot guidance [2.0, 7.5], injected initial noise.  On the CPU the
    JAX package never takes flash, so its rule on the TPU (q, kv >= 1024
    tokens) is patched in."""
    key = jax.random.PRNGKey(0)
    tr, un, ae = (jm.TransformerModel(**SLICE_TR), jm.UNet(**SLICE_UNET),
                  jm.AutoencoderKL(**SLICE_AE))
    ids = np.random.default_rng(5).integers(0, 100, (4, 8)).astype(np.int32)
    xt0 = _randn(np.random.default_rng(6), 2, 32, 32, 4)
    guidance = np.array([2.0, 7.5], np.float32).reshape(2, 1, 1, 1)
    weights = (
        _variables(lambda: tr.init(key, ids), gu.transformer_order(1), gu.SEED + 31),
        _variables(lambda: un.init(key, jnp.zeros((4, 32, 32, 4)), jnp.zeros((4,)),
                                   jnp.zeros((4, 8, 64))),
                   gu.unet_order(1, (1, 2)), gu.SEED + 32),
        _variables(lambda: ae.init({"params": key, "sample": key},
                                   jnp.zeros((1, 64, 64, 3))),
                   gu.autoencoder_kl_order(1, (1, 2), 64), gu.SEED + 33),
    )
    jschedule = jax_make_schedule(num_steps=50, beta_start=0.00085,
                                  beta_end=0.012, eta=0.0, num_ddim_steps=2)

    def jax_pipeline(weights, token_ids, xt0, guidance):
        tr_v, un_v, ae_v = weights
        context = tr.apply(tr_v, token_ids)
        x = jsampler.ddim_sample_loop(
            lambda x, t, c: un.apply(un_v, x, t, c), jschedule, context,
            tuple(xt0.shape), key, guidance_scale=guidance, init_noise=xt0)
        return x, ae.apply(ae_v, x / 0.18215, method=jm.AutoencoderKL.decode)

    monkeypatch.setattr(jattn, "_use_flash",
                        lambda q_len, kv_len: min(q_len, kv_len) >= 1024)
    jqc.set_conv_quant("int8")
    jfa.set_flash_pv_int8(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            jx0, jimages = jax.jit(jax_pipeline)(
                weights, jnp.asarray(ids), jnp.asarray(xt0), jnp.asarray(guidance))
        jx0, jimages = np.asarray(jx0), np.asarray(jimages)
    finally:
        jqc.set_conv_quant("none")
        jfa.set_flash_pv_int8(False)

    config = validate({"cond_stage_model": {}, "unet": {}, "autoencoder_kl": {},
                       "ldm": {}, "tpu": {"quantize": "int8",
                                          "quantize_attention": "int8pv"}})
    models = (load_params(tm.TransformerModel(**SLICE_TR), weights[0]),
              load_params(tm.UNet(**SLICE_UNET), weights[1]),
              load_params(tm.AutoencoderKL(**SLICE_AE), weights[2]))
    factory.apply_serving_modes(config, models[1], models[2])
    schedule = make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012,
                             eta=0.0, num_ddim_steps=2)

    # Record every int8 chain and int8-P.V attention the port runs, with
    # its inputs and output, to replay each through the JAX package below.
    chains, attentions, int8_route = [], [], []
    chain, chain_int8, pv = (tfc.gn_silu_conv3x3, tfc.gn_silu_conv3x3_int8,
                             tfa.flash_attention_pv_int8)

    def took_int8(*args, **kw):
        int8_route.append(True)
        return chain_int8(*args, **kw)

    def recorded_chain(x, gamma, beta, w, b, **kw):
        n = len(int8_route)
        out = chain(x, gamma, beta, w, b, **kw)
        if len(int8_route) > n:
            chains.append((x, gamma, beta, w, b, kw, out))
        return out

    def recorded_pv(q, k, v, scale):
        out = pv(q, k, v, scale)
        attentions.append((q, k, v, scale, out))
        return out

    monkeypatch.setattr(tfc, "gn_silu_conv3x3_int8", took_int8)
    monkeypatch.setattr(tunet, "gn_silu_conv3x3", recorded_chain)
    monkeypatch.setattr(tfa, "flash_attention_pv_int8", recorded_pv)
    images, x0 = cli.sample_txt2img(
        *models, schedule, _t(ids).long(), xt0.shape,
        guidance_scale=_t(guidance), init_noise=_t(xt0), device="cpu")
    # 16 chains and 3 level-0 self-attentions per U-Net eval, 2 evals, and
    # the autoencoder's mid-block attention.
    assert (len(chains), len(attentions)) == (32, 7)

    # End to end the two agree only to about what the int8 modes change,
    # so this bound alone cannot tell a right int8 route from a wrong one:
    # the replay below does.  A code that flips between the two (a value
    # within float32 noise of a rounding midpoint) moves its 3x3
    # neighbourhood by a whole step, and the next chain's rounding turns
    # that into more flips.  They end 1.6e-4 apart in x0, 9.6e-5 in pixels.
    assert _rel_l2(x0.numpy(), jx0) <= 5e-4
    assert _rel_l2(images.numpy(), jimages) <= 5e-4
    # The port with the modes off lies 1.3e-4 (x0) and 7.9e-5 (pixels) from
    # JAX's int8 result; the float32 pipelines agree to 1e-7, so this shows
    # that JAX's int8 route ran.
    monkeypatch.undo()
    models[1].set_serving_modes()
    models[2].set_serving_modes()
    images_off, x0_off = cli.sample_txt2img(
        *models, schedule, _t(ids).long(), xt0.shape,
        guidance_scale=_t(guidance), init_noise=_t(xt0), device="cpu")
    assert _rel_l2(x0_off.numpy(), jx0) > 1e-5
    assert _rel_l2(images_off.numpy(), jimages) > 1e-5

    # Each recorded call, replayed on the JAX package's kernels from the
    # port's own inputs, must agree far more closely than int8 moves it.
    # Chains: one flipped code moves about 1e-4 of a chain's output at these
    # widths; the replays stay within 7.7e-5, while int8 moves every chain
    # 1.6e-3 or more from its float32 form.
    jax_chain = jax.jit(jqc.gn_silu_conv3x3_int8, static_argnames="eps")
    with pltpu.force_tpu_interpret_mode(), torch.no_grad():
        for x, gamma, beta, w, b, kw, out in chains:
            extra = {k: kw.get(k) for k in ("time_add", "residual_add")}
            want = np.asarray(jax_chain(
                _np(x), _np(gamma), _np(beta), _np(w).transpose(2, 3, 1, 0),
                _np(b), eps=kw["eps"], **{k: _np(a) for k, a in extra.items()}))
            plain = chain(x, gamma, beta, w, b, eps=kw["eps"], **extra)
            gap, effect = _rel_l2(_np(out), want), _rel_l2(_np(plain), want)
            assert gap <= 5e-4 and gap <= effect / 10, (x.shape, gap, effect)

    # Attention (tolerance: see PV_ATOL): the replays agree to 8e-8 in
    # relative L2, while int8 P.V moves these near-uniform attentions 1.7e-4
    # or more from exact attention.
    jax_pv = {}  # one trace per scale, made with the mode on
    jfa.set_flash_pv_int8(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            for q, k, v, scale, out in attentions:
                if scale not in jax_pv:
                    jax_pv[scale] = jax.jit(
                        lambda q, k, v, s=scale: jfa.flash_attention(q, k, v, s))
                want = np.asarray(jax_pv[scale](_np(q), _np(k), _np(v)))
                exact = dot_product_attention(q, k, v, scale).numpy()
                assert float(np.abs(out.numpy() - want).max()) <= PV_ATOL
                assert _rel_l2(out.numpy(), want) <= _rel_l2(exact, want) / 100
    finally:
        jfa.set_flash_pv_int8(False)
