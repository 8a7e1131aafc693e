"""The PyTorch port's txt2img pipeline (text encode -> CFG DDIM -> KL
decode) against the reference goldens and the JAX pipeline.

Same models, seeds and injected noise as ``tests/test_pipeline_parity.py``,
held to its CPU tolerances: latents rtol 1e-3 / atol 1e-4, pixels max abs
< 1e-2 and rtol 1e-2 / atol 1e-3.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.diffusion import sampler as jsampler
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

TRANSFORMER = dict(vocab_size=100, encoder_stack_size=1, hidden_size=1280,
                   num_heads=8, size_per_head=64, max_seq_len=8,
                   filter_size=256, dropout_rate=0.0)
UNET = dict(model_channels=160, out_channels=4, num_blocks=1,
            channel_mult=(1, 2), num_heads=4, context_channels=1280,
            dropout_rate=0.0)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))


def _variables(init, order, seed):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


@functools.lru_cache(maxsize=None)
def _tiny_weights(seed_offset):
    """JAX param trees of the tiny pipeline (golden seeds +1/+2/+3 for
    txt2img_pipeline, +21/+22/+23 for the eta=1 golden)."""
    key = jax.random.PRNGKey(0)
    tr, un, ae = (jm.TransformerModel(**TRANSFORMER), jm.UNet(**UNET),
                  jm.AutoencoderKL(**AE))
    ids = jnp.zeros((4, 8), jnp.int32)
    return (
        _variables(lambda: tr.init(key, ids), gu.transformer_order(1),
                   gu.SEED + seed_offset),
        _variables(lambda: un.init(key, jnp.zeros((4, 8, 8, 4)),
                                   jnp.zeros((4,)), jnp.zeros((4, 8, 1280))),
                   gu.unet_order(1, (1, 2)), gu.SEED + seed_offset + 1),
        _variables(lambda: ae.init({"params": key, "sample": key},
                                   jnp.zeros((1, 16, 16, 3))),
                   gu.autoencoder_kl_order(1, (1, 2), 16),
                   gu.SEED + seed_offset + 2),
    )


def _port_models(weights):
    tr, un, ae = weights
    return (load_params(tm.TransformerModel(**TRANSFORMER), tr),
            load_params(tm.UNet(**UNET), un),
            load_params(tm.AutoencoderKL(**AE), ae))


def _assert_golden(x_final, images, g):
    np.testing.assert_allclose(x_final, g["x_final"], rtol=1e-3, atol=1e-4)
    assert float(np.abs(images - g["images"]).max()) < 1e-2
    np.testing.assert_allclose(images, g["images"], rtol=1e-2, atol=1e-3)


def test_txt2img_pipeline_matches_golden_and_jax():
    g = np.load(os.path.join(GOLDENS, "txt2img_pipeline.npz"))
    weights = _tiny_weights(1)
    schedule = make_schedule(num_steps=50, beta_start=0.00085,
                             beta_end=0.012, eta=0.0, num_ddim_steps=5)
    images, x0 = cli.sample_txt2img(
        *_port_models(weights), schedule, torch.as_tensor(g["token_ids"]),
        g["xt0"].shape, guidance_scale=5.0,
        init_noise=torch.as_tensor(g["xt0"]), device="cpu",
    )
    images, x0 = images.numpy(), x0.numpy()
    _assert_golden(x0, images, g)

    tr, un, ae = (jm.TransformerModel(**TRANSFORMER), jm.UNet(**UNET),
                  jm.AutoencoderKL(**AE))
    jschedule = jax_make_schedule(num_steps=50, beta_start=0.00085,
                                  beta_end=0.012, eta=0.0, num_ddim_steps=5)

    @jax.jit
    def jax_pipeline(weights, token_ids, xt0):
        tr_v, un_v, ae_v = weights
        context = tr.apply(tr_v, token_ids)
        x = jsampler.ddim_sample_loop(
            lambda x, t, c: un.apply(un_v, x, t, c), jschedule, context,
            tuple(xt0.shape), jax.random.PRNGKey(0), guidance_scale=5.0,
            init_noise=xt0,
        )
        return x, ae.apply(ae_v, x / 0.18215, method=jm.AutoencoderKL.decode)

    jx0, jimages = jax_pipeline(weights, jnp.asarray(g["token_ids"], jnp.int32),
                                jnp.asarray(g["xt0"]))
    # both f32 on the CPU: only summation order differs
    np.testing.assert_allclose(x0, np.asarray(jx0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(images, np.asarray(jimages), rtol=1e-4,
                               atol=1e-4)


def test_txt2img_eta1_with_injected_noise_matches_golden():
    g = np.load(os.path.join(GOLDENS, "txt2img_pipeline_eta1.npz"))
    schedule = make_schedule(num_steps=50, beta_start=0.00085,
                             beta_end=0.012, eta=1.0, num_ddim_steps=10)
    images, x0, traj = cli.sample_txt2img(
        *_port_models(_tiny_weights(21)), schedule,
        torch.as_tensor(g["token_ids"]), g["xt0"].shape, guidance_scale=5.0,
        init_noise=torch.as_tensor(g["xt0"]),
        step_noises=torch.as_tensor(g["noises"]), return_trajectory=True,
        device="cpu",
    )
    np.testing.assert_allclose(traj.numpy(), g["traj"], rtol=1e-3, atol=1e-4)
    _assert_golden(x0.numpy(), images.numpy(), g)


def test_schedule_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDENS, "schedule.npz"))
    for spacing in ("uniform", "trailing", "karras"):
        ours = make_schedule(beta_start=0.00085, beta_end=0.012, eta=1.0,
                             num_ddim_steps=50, timestep_spacing=spacing)
        ref = jax_make_schedule(beta_start=0.00085, beta_end=0.012, eta=1.0,
                                num_ddim_steps=50, timestep_spacing=spacing)
        for field in ref.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(ours, field),
                                          getattr(ref, field), err_msg=field)
    ours = make_schedule(beta_start=0.00085, beta_end=0.012, eta=1.0,
                         num_ddim_steps=50)
    np.testing.assert_array_equal(ours.ddim_steps, g["ddim_steps"])
    np.testing.assert_allclose(ours.ddim_sigmas, g["ddim_sigmas"], rtol=1e-4)


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_cfg_and_ddim_update_match_jax(rescale):
    rng = np.random.default_rng(0)
    eps2 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    xt = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = tsampler.apply_cfg(torch.as_tensor(eps2), 5.0, rescale)
    jeps = jsampler.apply_cfg(jnp.asarray(eps2), 5.0, rescale)
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=1e-5,
                               atol=1e-5)
    schedule = make_schedule(num_steps=50, eta=1.0, num_ddim_steps=10)
    jschedule = jax_make_schedule(num_steps=50, eta=1.0, num_ddim_steps=10)
    for index in (0, 4, 9):
        got, got_x0 = tsampler.ddim_update(
            schedule, torch.as_tensor(xt), eps, index, noise=torch.as_tensor(noise)
        )
        want, want_x0 = jsampler.ddim_update(
            jschedule, jnp.asarray(xt), jeps, index, jax.random.PRNGKey(0),
            noise=jnp.asarray(noise),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0),
                                   rtol=1e-5, atol=1e-5)


def test_cli_writes_images_from_a_jax_blob(tmp_path, monkeypatch):
    """The CLI end to end on the CPU: a blob exported by the JAX package in,
    ``images.npy`` out."""
    tr, un, ae = (w["params"] for w in _tiny_weights(1))
    # the golden transformer has a 100-token vocabulary; widen its embedding
    # so real token ids index it
    emb = tr["token_embedding"]["embedding"]
    tr = {**tr, "token_embedding": {"embedding": np.resize(emb, (30522, 1280))}}
    export_blob(str(tmp_path / "params"),
                {"cond_stage_model": tr, "unet": un, "autoencoder": ae})
    vocab = os.path.join(os.path.dirname(GOLDENS), os.pardir, "bert_model")
    config = tmp_path / "config.yaml"
    config.write_text(f"""
cond_stage_model: {{vocab_size: 30522, encoder_stack_size: 1, hidden_size: 1280,
  num_heads: 8, size_per_head: 64, max_seq_len: 8, filter_size: 256,
  dropout_rate: 0.0}}
unet: {{model_channels: 160, out_channels: 4, num_blocks: 1,
  attention_resolutions: [1], dropout_rate: 0.0, channel_mult: [1, 2],
  num_heads: 4}}
autoencoder_kl: {{latent_channels: 4, channels: 32, num_blocks: 1,
  attention_resolutions: [], dropout_rate: 0.0, multipliers: [1, 2],
  resample_with_conv: true}}
ldm: {{num_steps: 50, beta_start: 0.00085, beta_end: 0.012, v_posterior: 0.0,
  scale_factor: 0.18215, eta: 0.0, num_ddim_steps: 2}}
ldm_sampling: {{guidance_scale: 5.0, latent_shape: [2, 8, 8, 4],
  text_prompt: "a red fox", vocab_dir: {os.path.abspath(vocab)},
  autoencoder_type: kl}}
tpu: {{compute_dtype: float32}}
""")
    monkeypatch.chdir(tmp_path)
    cli.main(["--config_path", str(config), "--params_blob",
              str(tmp_path / "params"), "--device", "cpu"])
    images = np.load(tmp_path / "images.npy")
    assert images.shape == (2, 16, 16, 3) and images.dtype == np.uint8
    assert images.min() == 0 and images.max() == 255


def test_cli_refuses_unported_branches():
    """Only the mesh is left unported; DeepCache and img2img pass the check."""
    config = {"ldm_sampling": {"init_image_path": "init.npy"},
              "tpu": {"quantize": "none", "quantize_attention": "none",
                      "sequence_parallel": False, "tensor_parallel": False}}
    cli.check_supported(config)
    config["ldm_sampling"] = {"cache_interval": 2}
    cli.check_supported(config)
    config["tpu"]["sequence_parallel"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item A6"):
        cli.check_supported(config)


@pytest.mark.slow
def test_txt2img_production_50step_matches_golden():
    """The north star: 32-layer text encoder, the 0.87B U-Net and the f8
    KL decoder at 256^2, 50 CFG DDIM steps, every step of the trajectory
    held to the golden (``test_pipeline_parity.py``'s 50-step test)."""
    g = np.load(os.path.join(GOLDENS, "txt2img_pipeline_prod50.npz"))
    key = jax.random.PRNGKey(0)
    tr_kw = dict(vocab_size=30522, encoder_stack_size=32, hidden_size=1280,
                 num_heads=8, size_per_head=64, max_seq_len=77,
                 filter_size=5120, dropout_rate=0.0)
    un_kw = dict(model_channels=320, out_channels=4, num_blocks=2,
                 channel_mult=(1, 2, 4, 4), num_heads=8,
                 context_channels=1280, dropout_rate=0.0)
    ae_kw = dict(channels=128, num_blocks=2, multipliers=(1, 2, 4, 4))
    ids = jnp.asarray(g["token_ids"], jnp.int32)
    trees = (
        _variables(lambda: jm.TransformerModel(**tr_kw).init(key, ids),
                   gu.transformer_order(32), gu.SEED + 13),
        _variables(lambda: jm.UNet(**un_kw).init(
            key, jnp.zeros((2, 32, 32, 4)), jnp.zeros((2,)),
            jnp.zeros((2, 77, 1280))),
            gu.unet_order(2, (1, 2, 4, 4)), gu.SEED + 14),
        _variables(lambda: jm.AutoencoderKL(**ae_kw).init(
            {"params": key, "sample": key}, jnp.zeros((1, 64, 64, 3))),
            gu.autoencoder_kl_order(2, (1, 2, 4, 4), 64), gu.SEED + 15),
    )
    models = (load_params(tm.TransformerModel(**tr_kw), trees[0]),
              load_params(tm.UNet(**un_kw), trees[1]),
              load_params(tm.AutoencoderKL(**ae_kw), trees[2]))
    schedule = make_schedule(beta_start=0.00085, beta_end=0.012, eta=0.0,
                             num_ddim_steps=50)
    images, x0, traj = cli.sample_txt2img(
        *models, schedule, torch.as_tensor(g["token_ids"]), g["xt0"].shape,
        guidance_scale=5.0, init_noise=torch.as_tensor(g["xt0"]),
        return_trajectory=True, device="cpu",
    )
    drift = np.abs(traj.numpy() - g["traj"]).max(axis=(1, 2, 3, 4))
    assert float(drift.max()) < 1e-2, drift
    np.testing.assert_allclose(x0.numpy(), g["x_final"], rtol=1e-3, atol=1e-3)
    assert float(np.abs(images.numpy() - g["images"]).max()) < 1e-2
