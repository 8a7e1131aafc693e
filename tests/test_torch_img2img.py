"""The port's image to image and inpainting against the JAX package's.

``diffusion/sampler.py::ddim_img2img_loop`` at strength 0 to 1 (7 DDIM
steps, so 0.5 exercises round-half-to-even: 3.5 -> 4), with and without a
mask, on a one-layer stand-in U-Net, the JAX loop's key splits replayed and
handed to the port (``init_noise``, ``step_noises``, ``keep_noises``):
float32 at rtol 1e-4 / atol 1e-5, and a bf16 carry with a float32 mask
(kept region exact, dtype kept).  Then the sampler CLI's loading: the mask
resize against ``jax.image.resize(..., "nearest")`` bit for bit, ``main``
with an init image and a mask on a JAX-exported blob against
``sample_img2img`` with the same seed, and the JAX CLI's refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.diffusion import sampler as jsampler
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "bert_model")
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 8, 8, 4)
STEPS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(JAX eps model, port eps model, context, init latent, schedules): the
    stand-in ``tanh(x W1 + t/1000 u + mean(c) W2)`` in the input's dtype,
    a 7-step schedule with eta 1 (so the step noise is replayed too)."""
    rng = np.random.default_rng(71)
    w1 = rng.standard_normal((4, 4)).astype(np.float32) * 0.5
    u = rng.standard_normal(4).astype(np.float32)
    w2 = rng.standard_normal((16, 4)).astype(np.float32) * 0.1
    context = rng.standard_normal((4, 3, 16)).astype(np.float32)
    init = rng.standard_normal(SHAPE).astype(np.float32)

    def jeps(x, t, c):
        x32, c32 = x.astype(jnp.float32), c.astype(jnp.float32)
        return jnp.tanh(x32 @ w1 + (t / 1000.0)[:, None, None, None] * u
                        + (jnp.mean(c32, axis=1) @ w2)[:, None, None, :]).astype(x.dtype)

    tw1, tu, tw2 = (torch.from_numpy(a) for a in (w1, u, w2))

    def teps(x, t, c):
        return torch.tanh(x.float() @ tw1 + (t / 1000.0)[:, None, None, None] * tu
                          + (c.float().mean(dim=1) @ tw2)[:, None, None, :]).to(x.dtype)

    kw = dict(num_steps=42, beta_start=0.00085, beta_end=0.012, num_ddim_steps=STEPS,
              eta=1.0)
    return jeps, teps, context, init, jax_make_schedule(**kw), make_schedule(**kw)


def _replayed_draws(key, steps, dtype):
    """The JAX loop's draws: (key, noise_key) for the forward noise, then
    (key, step_key, blend_key) once a step, in loop order."""
    key, noise_key = jax.random.split(key)
    noise0 = jax.random.normal(noise_key, SHAPE, dtype)
    step, keep = [], []
    for _ in range(steps):
        key, step_key, blend_key = jax.random.split(key, 3)
        step.append(jax.random.normal(step_key, SHAPE, dtype))
        keep.append(jax.random.normal(blend_key, SHAPE, dtype))
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32))
    if not steps:
        return as_t(noise0).to(_TORCH[dtype]), None, None
    return (as_t(noise0).to(_TORCH[dtype]), as_t(jnp.stack(step)),
            as_t(jnp.stack(keep)))


_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _half_mask():
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0  # the left half regenerated
    return mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strength,t_enc", [(0.0, 0), (0.5, 4), (0.75, 5), (1.0, 7)])
def test_img2img_loop_matches_jax(setup, strength, t_enc, masked):
    jeps, teps, context, init, jschedule, schedule = setup
    assert int(round(strength * STEPS)) == t_enc
    mask = _half_mask() if masked else None
    key = jax.random.PRNGKey(int(strength * 100) + masked)
    with jax.disable_jit():  # op by op: the ops compile once for every case
        want = np.asarray(jsampler.ddim_img2img_loop(
            jeps, jschedule, jnp.asarray(context), jnp.asarray(init), key,
            strength=strength, guidance_scale=5.0,
            mask=None if mask is None else jnp.asarray(mask)))
    noise0, steps, keeps = _replayed_draws(key, t_enc, jnp.float32)
    calls = []

    def counted(*args):
        calls.append(1)
        return teps(*args)

    with torch.no_grad():
        got = tsampler.ddim_img2img_loop(
            counted, schedule, torch.from_numpy(context), torch.from_numpy(init),
            strength=strength, guidance_scale=5.0,
            mask=None if mask is None else torch.from_numpy(mask), init_noise=noise0,
            step_noises=steps, keep_noises=keeps)
    assert len(calls) == t_enc
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if masked:  # the kept half is the init latent itself
        np.testing.assert_array_equal(got.numpy()[:, :, 4:], init[:, :, 4:])
    if t_enc:
        assert float(np.abs(got.numpy()[:, :, :4] - init[:, :, :4]).max()) > 0.1


def test_img2img_bf16_carry_with_f32_mask(setup):
    """A float32 mask never upcasts a bf16 sample; the kept region is the
    init latent exactly (the JAX package's
    ``test_img2img_bf16_carry_with_f32_mask``, on the port and on JAX's
    draws).  eta 0, as there: at eta 1 the JAX loop's bf16 coefficients
    give sqrt(1 - acp_prev - sigma^2) of a negative number at index 0."""
    jeps, teps, context, init, _, _ = setup
    kw = dict(num_steps=42, beta_start=0.00085, beta_end=0.012, num_ddim_steps=STEPS)
    jschedule, schedule = jax_make_schedule(**kw), make_schedule(**kw)
    key = jax.random.PRNGKey(5)
    init16 = jnp.asarray(init, jnp.bfloat16)
    with jax.disable_jit():
        want = jsampler.ddim_img2img_loop(
            jeps, jschedule, jnp.asarray(context, jnp.bfloat16), init16, key,
            strength=0.5, guidance_scale=2.0, mask=jnp.asarray(_half_mask()))
    assert want.dtype == jnp.bfloat16
    noise0, steps, keeps = _replayed_draws(key, 4, jnp.bfloat16)
    init_t = torch.from_numpy(np.array(init16.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got = tsampler.ddim_img2img_loop(
            teps, schedule, torch.from_numpy(context).bfloat16(), init_t, strength=0.5,
            guidance_scale=2.0, mask=torch.from_numpy(_half_mask()), init_noise=noise0,
            step_noises=steps, keep_noises=keeps)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[:, :, 4:], init_t[:, :, 4:])
    np.testing.assert_array_equal(np.asarray(want[:, :, 4:], np.float32),
                                  init_t[:, :, 4:].float().numpy())
    assert float((got[:, :, :4].float() - init_t[:, :, :4].float()).abs().max()) > 0.1


def test_strength_out_of_range_raises(setup):
    _, teps, context, init, _, schedule = setup
    with pytest.raises(ValueError, match=r"strength must be in \[0, 1\], got 1.5"):
        tsampler.ddim_img2img_loop(teps, schedule, torch.from_numpy(context),
                                   torch.from_numpy(init), strength=1.5)


# -------------------------------------------------------------------- CLI --

@pytest.mark.parametrize("mask_shape,latent_hw", [
    ((256, 256), (32, 32)),  # f8: source index 8i + 4
    ((2, 64, 48), (8, 6)),
    ((1, 16, 16), (8, 8)),
])
def test_mask_resize_matches_jax_nearest(tmp_path, mask_shape, latent_hw):
    """The mask differs within every block, so a resize that picks another
    pixel of the block (``F.interpolate(mode="nearest")`` picks 8i) fails."""
    mask = (np.random.default_rng(3).random(mask_shape) > 0.5).astype(np.float32)
    np.save(tmp_path / "mask.npy", mask)
    got = cli.load_mask(str(tmp_path / "mask.npy"), (2, *latent_hw, 4))
    m = mask[None] if mask.ndim == 2 else mask
    want = np.asarray(jax.image.resize(jnp.asarray(m), (m.shape[0], *latent_hw),
                                       "nearest"))[..., None]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    step = m.shape[1] // latent_hw[0]
    assert not np.array_equal(got[..., 0], m[:, ::step, ::m.shape[2] // latent_hw[1]])


TR = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64, num_heads=2,
          size_per_head=32, max_seq_len=8, filter_size=128, dropout_rate=0.0)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, dropout_rate=0.0)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))


def _variables_of(module, order, seed):
    """``golden_utils.materialize``'s weights for the port ``module``, the
    zeros tree read off its ``state_dict`` (the bridge's naming, OIHW
    kernels back to HWIO) instead of tracing the JAX module's init."""
    tree = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        shape = tuple(value.shape)
        node[leaf] = np.zeros(shape[2:] + shape[1::-1] if len(shape) == 4 else shape,
                              np.float32)
    return gu.materialize({"params": tree}, order, seed)


def _config(**sampling):
    return {
        "cond_stage_model": dict(TR),
        "unet": {**UNET, "channel_mult": [1, 2], "attention_resolutions": [1]},
        "autoencoder_kl": dict(latent_channels=4, attention_resolutions=[],
                               dropout_rate=0.0, resample_with_conv=True,
                               channels=32, num_blocks=1, multipliers=[1, 2]),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=0.0, num_ddim_steps=5),
        "ldm_sampling": {**dict(guidance_scale=5.0, latent_shape=list(SHAPE),
                                text_prompt="a red fox", vocab_dir=VOCAB,
                                autoencoder_type="kl"), **sampling},
        "tpu": {"compute_dtype": "float32"},
    }


def test_cli_img2img_with_mask_matches_sample_img2img(tmp_path, monkeypatch):
    """``main`` with an init image ([H, W, 3] uint8, tiled to the batch) and a
    mask on a JAX-exported blob: ``images.npy`` equals ``sample_img2img``
    with the same seed, on the image mapped to [-1, 1] and the mask resized
    by ``jax.image.resize``."""
    export_blob(str(tmp_path / "params"), {
        "cond_stage_model": _variables_of(tm.TransformerModel(**TR),
                                          gu.transformer_order(1), gu.SEED + 74)["params"],
        "unet": _variables_of(tm.UNet(**UNET, context_channels=64),
                              gu.unet_order(1, (1, 2)), gu.SEED + 75)["params"],
        "autoencoder": _variables_of(tm.AutoencoderKL(**AE),
                                     gu.autoencoder_kl_order(1, (1, 2), 16),
                                     gu.SEED + 76)["params"],
    })
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    mask = (rng.random((16, 16)) > 0.5).astype(np.float32)
    np.save(tmp_path / "init.npy", image)
    np.save(tmp_path / "mask.npy", mask)
    config = _config(init_image_path=str(tmp_path / "init.npy"),
                     mask_path=str(tmp_path / "mask.npy"), strength=0.5)
    (tmp_path / "config.json").write_text(json.dumps(config))  # JSON is YAML
    monkeypatch.chdir(tmp_path)
    cli.main(["--config_path", str(tmp_path / "config.json"), "--params_blob",
              str(tmp_path / "params"), "--seed", "2", "--device", "cpu"])

    config = validate(config)
    blob = read_blob(str(tmp_path / "params"))
    models = (load_params(factory.build_cond_model(config), blob["cond_stage_model"]),
              load_params(factory.build_unet(config), blob["unet"]),
              load_params(factory.build_autoencoder(config, "kl"), blob["autoencoder"]))
    ids = torch.as_tensor(cfg_token_ids(load_tokenizer(VOCAB), "a red fox", 2, 8))
    init_image = np.tile(image[None].astype(np.float32) / 127.5 - 1.0, (2, 1, 1, 1))
    latent_mask = np.array(jax.image.resize(jnp.asarray(mask[None]), (1, 8, 8),
                                              "nearest"))[..., None]
    images, x0, init_latent = cli.sample_img2img(
        *models, factory.build_schedule(config), ids, init_image,
        mask=torch.from_numpy(latent_mask), strength=0.5, guidance_scale=5.0, seed=2,
        device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "images.npy"),
                                  cli.tensor_to_image(images.numpy()))
    keep = np.broadcast_to(latent_mask == 0, x0.shape)
    np.testing.assert_array_equal(x0.numpy()[keep], init_latent.numpy()[keep])
    assert not np.array_equal(x0.numpy()[~keep], init_latent.numpy()[~keep])


@pytest.mark.parametrize("sampling,what", [
    ({"sampler": "euler"}, "sampler must be one of"),
    ({"sampler": "plms", "sample_save_progress": True},
     "sample_save_progress only supports sampler: ddim"),
    ({"cache_interval": 2, "sample_save_progress": True},
     "cache_interval > 1 does not support sample_save_progress"),
    ({"init_image_path": "i.npy", "sampler": "plms"},
     "init_image_path requires sampler: ddim without sample_save_progress or "
     "cache_interval"),
    ({"init_image_path": "i.npy", "cache_interval": 3},
     "init_image_path requires sampler: ddim"),
    ({"mask_path": "m.npy"}, "mask_path requires init_image_path"),
])
def test_cli_refuses_what_the_jax_cli_refuses(sampling, what):
    with pytest.raises(ValueError, match=what):
        cli.check_sampling(sampling)


@pytest.mark.parametrize("image_shape,what", [
    ((3, 16, 16, 3), "init image batch 3 != latent batch 2"),
    ((1, 24, 16, 3), r"init image is \(24, 16\), but latent_shape \(8, 8\) with the "
                     r"f2 autoencoder needs \(16, 16\)"),
])
def test_init_image_checks(tmp_path, image_shape, what):
    np.save(tmp_path / "i.npy", np.zeros(image_shape, np.uint8))
    with pytest.raises(ValueError, match=what):
        cli.load_init_image(str(tmp_path / "i.npy"), validate(_config()))
