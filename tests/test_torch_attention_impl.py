"""``tpu.attention_impl`` in the port against the JAX package: the loader
refuses other values with the JAX message, "xla" sends every attention to
``dot_product_attention`` (no flash call), "flash" sends every attention
the JAX package's ``_use_flash`` takes to the flash wrapper, and under each
value a small U-Net and text encoder give the JAX modules' outputs on the
same weights (float32; the JAX flash kernel runs in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.configs import loader as jloader
from ldm_tf2_tpu.ops import attention as jattn
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.configs import loader as tloader
from ldm_tf2_tpu_torch.ops import attention as tattn
from ldm_tf2_tpu_torch.ops import flash_attention as tfa

IMPLS = ("auto", "xla", "flash")


def _variables(init, order):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, gu.SEED)


@pytest.fixture
def impl_reset():
    yield
    tattn.set_attention_impl("auto")
    jattn.set_attention_impl("auto")


@pytest.fixture
def flash_calls(monkeypatch):
    """Calls of the flash wrappers, by name, through the module attributes
    the dispatch reads."""
    calls = {"flash_attention": 0, "flash_attention_pv_int8": 0}
    for name in calls:
        wrapped = getattr(tfa, name)

        def counting(*args, _name=name, _fn=wrapped, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tfa, name, counting)
    return calls


def _config(impl):
    return {"cond_stage_model": {}, "unet": {}, "autoencoder_kl": {},
            "ldm": {"num_steps": 1000}, "ldm_sampling": {},
            "tpu": {"attention_impl": impl}}


def test_loader_rejects_an_unknown_value_with_the_jax_message():
    with pytest.raises(ValueError) as port:
        tloader.validate(_config("bogus"))
    assert str(port.value) == "tpu.attention_impl must be auto|xla|flash, got 'bogus'"
    source = open(jloader.__file__).read()
    assert "tpu.attention_impl must be auto|xla|flash, got " in source
    for impl in IMPLS:
        assert tloader.validate(_config(impl))["tpu"]["attention_impl"] == impl
    assert tloader.validate({**_config("auto"), "tpu": {}})["tpu"]["attention_impl"] == "auto"


def test_factory_applies_the_value(impl_reset):
    for impl in ("xla", "flash", "auto"):
        factory.apply_tpu_settings(tloader.validate(_config(impl)))
        assert tattn.get_attention_impl() == impl
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.set_attention_impl("bogus")


def _unet_pair():
    kwargs = dict(model_channels=32, out_channels=4, num_blocks=1,
                  channel_mult=(1, 2), num_heads=2, context_channels=64,
                  dropout_rate=0.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.asarray([321.0], np.float32)
    ctx = rng.standard_normal((1, 5, 64)).astype(np.float32)
    jax_model = jm.UNet(**kwargs)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), x, t, ctx),
                           gu.unet_order(num_blocks=1, channel_mult=(1, 2)))
    model = load_params(tm.UNet(**kwargs), variables)
    return jax_model, variables, model, (x, t, ctx)


@pytest.mark.parametrize("impl", IMPLS)
def test_unet_matches_jax_under_each_value(impl, impl_reset, flash_calls):
    """The U-Net's self-attentions (64 and 16 tokens) and cross-attentions
    (5 tokens): "xla" takes no flash call, "auto" (the port's default
    route) one per self-attention, "flash" one per attention."""
    jax_model, variables, model, inputs = _unet_pair()
    jattn.set_attention_impl(impl)
    want = np.asarray(jax_model.apply(variables, *inputs))
    tattn.set_attention_impl(impl)
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    blocks = sum(isinstance(m, tm.unet.BasicTransformerBlock) for m in model.modules())
    want = {"auto": blocks, "xla": 0, "flash": 2 * blocks}[impl]
    assert blocks > 0
    assert flash_calls == {"flash_attention": want, "flash_attention_pv_int8": 0}


@pytest.mark.parametrize("impl", IMPLS)
def test_xla_turns_int8_pv_off_as_in_jax(impl, impl_reset, flash_calls):
    """With the int8-P.V serving mode on: "xla" runs no int8 P.V (plain
    attention), "flash" runs it on every self-attention (the JAX kernel
    runs int8 P.V wherever it runs), "auto" only from 1024 tokens (none
    here)."""
    _, _, model, inputs = _unet_pair()
    model.set_serving_modes(attention_pv_int8=True)
    tattn.set_attention_impl(impl)
    with torch.no_grad():
        out = model(*(torch.as_tensor(a) for a in inputs))
    assert bool(torch.isfinite(out).all())
    blocks = sum(isinstance(m, tm.unet.BasicTransformerBlock) for m in model.modules())
    assert flash_calls["flash_attention_pv_int8"] == (blocks if impl == "flash" else 0)
    # the cross-attentions under "flash", the self-attentions under "auto"
    assert flash_calls["flash_attention"] == {"auto": blocks, "xla": 0, "flash": blocks}[impl]


@pytest.mark.parametrize("impl", IMPLS)
def test_text_encoder_matches_jax_under_each_value(impl, impl_reset, flash_calls):
    kwargs = dict(vocab_size=100, encoder_stack_size=2, hidden_size=64,
                  num_heads=2, size_per_head=32, max_seq_len=8,
                  filter_size=128, dropout_rate=0.0)
    ids = np.random.default_rng(5).integers(0, 100, (2, 8)).astype(np.int32)
    jax_model = jm.TransformerModel(**kwargs)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.asarray(ids)),
                           gu.transformer_order(2))
    model = load_params(tm.TransformerModel(**kwargs), variables)
    jattn.set_attention_impl(impl)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(ids)))
    tattn.set_attention_impl(impl)
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert flash_calls["flash_attention"] == (2 if impl == "flash" else 0)


def test_packed_cross_has_no_effect_under_xla(impl_reset):
    tattn.set_packed_cross(True)
    try:
        tattn.set_attention_impl("xla")
        assert not tattn.use_packed_cross(1024, 77, 40)
        tattn.set_attention_impl("auto")
        assert tattn.use_packed_cross(1024, 77, 40)
    finally:
        tattn.set_packed_cross(False)
