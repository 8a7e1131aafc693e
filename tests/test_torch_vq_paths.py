"""The VQ autoencoder in the port's sampling CLI, server and LDM trainer,
held to the JAX paths on tiny configs, on the CPU.

The JAX CLIs decode with ``AutoencoderVQ.decode(force_quantize=True)`` and
the LDM trainer encodes with ``encode(only_encode=True)`` (no posterior
draw); the port does the same.  Weights: the VQ golden's materialized
tree (16^2 images, 8x8x4 latents, codebook 32x4) beside the tiny
pipeline's text encoder and U-Net.  Float32 on both sides: only summation
order differs (rtol 1e-4), except where a latent lies near the midpoint of
two codes, which no input here does (the indices are compared exactly).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.diffusion import sampler as jsampler
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.cli import serve_ldm
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
VOCAB = os.path.join(ROOT, "bert_model")
IMG = 16
TR = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64, num_heads=2,
          size_per_head=32, max_seq_len=8, filter_size=128, dropout_rate=0.0)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, dropout_rate=0.0)
VQ = dict(channels=32, num_blocks=1, multipliers=(1, 2), attention_resolutions=(8,),
          vocab_size=32)


def _variables(init, order, seed):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


def _weights():
    key = jax.random.PRNGKey(0)
    tr, un, ae = jm.TransformerModel(**TR), jm.UNet(**UNET, context_channels=64), \
        jm.AutoencoderVQ(**VQ)
    trv = _variables(lambda: tr.init(key, jnp.zeros((4, 8), jnp.int32)),
                     gu.transformer_order(1), gu.SEED + 31)
    unv = _variables(lambda: un.init(key, jnp.zeros((4, 8, 8, 4)), jnp.zeros((4,)),
                                     jnp.zeros((4, 8, 64))),
                     gu.unet_order(1, (1, 2)), gu.SEED + 32)
    aev = _variables(lambda: ae.init(key, jnp.zeros((1, IMG, IMG, 3))),
                     gu.autoencoder_vq_order(1, (1, 2), IMG, (8,)), gu.SEED + 33)
    return (tr, un, ae), (trv, unv, aev)


def _config(**sampling):
    return validate({
        "cond_stage_model": dict(TR),
        "unet": dict(UNET, attention_resolutions=[1], channel_mult=[1, 2]),
        "autoencoder_kl": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True),
        "autoencoder_vq": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[8], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True,
                               vocab_size=32, beta=0.25),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=0.0, num_ddim_steps=2),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[2, 8, 8, 4],
                             text_prompt="a red fox", vocab_dir=VOCAB,
                             autoencoder_type="vq", **sampling),
        "tpu": {"compute_dtype": "float32"},
    })


def _blob(path, variables):
    export_blob(path, {name: v["params"] for name, v in
                       zip(("cond_stage_model", "unet", "autoencoder"), variables)})


def test_sampler_decodes_vq_like_jax(tmp_path, monkeypatch):
    (tr, un, ae), variables = _weights()
    rng = np.random.default_rng(0)
    ids = rng.integers(100, 2000, (4, 8)).astype(np.int32)
    xt0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jschedule = jax_make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012,
                                  eta=0.0, num_ddim_steps=2)

    @jax.jit
    def jax_pipeline(variables, ids, xt0):
        trv, unv, aev = variables
        context = tr.apply(trv, ids)
        x = jsampler.ddim_sample_loop(lambda x, t, c: un.apply(unv, x, t, c), jschedule,
                                      context, tuple(xt0.shape), jax.random.PRNGKey(0),
                                      guidance_scale=5.0, init_noise=xt0)
        return x, ae.apply(aev, x / 0.18215, force_quantize=True,
                           method=jm.AutoencoderVQ.decode)

    jx0, jimages = (np.asarray(a) for a in jax_pipeline(variables, ids, xt0))
    models = (load_params(tm.TransformerModel(**TR), variables[0]),
              load_params(tm.UNet(**UNET, context_channels=64), variables[1]),
              load_params(tm.AutoencoderVQ(**VQ, resolution=IMG), variables[2]))
    schedule = make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012,
                             eta=0.0, num_ddim_steps=2)
    images, x0 = cli.sample_txt2img(*models, schedule, torch.as_tensor(ids), xt0.shape,
                                    init_noise=torch.as_tensor(xt0), device="cpu")
    np.testing.assert_allclose(x0.numpy(), jx0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(images.numpy(), jimages, rtol=1e-4, atol=1e-4)
    # the quantizer ran: the decode of the raw latents differs
    with torch.no_grad():
        raw = models[2].decode(x0 / 0.18215)
    assert float((raw - images).abs().max()) > 1e-3

    # the CLI end to end on a blob with a VQ autoencoder
    _blob(str(tmp_path / "params"), variables)
    import yaml

    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(_config()))
    monkeypatch.chdir(tmp_path)
    cli.main(["--config_path", str(config), "--params_blob", str(tmp_path / "params"),
              "--device", "cpu"])
    out = np.load(tmp_path / "images.npy")
    assert out.shape == (2, IMG, IMG, 3) and out.dtype == np.uint8


def test_server_serves_vq_like_the_pipeline(tmp_path):
    """``serve`` builds the VQ autoencoder from the blob and decodes with
    force_quantize: its images equal the direct pipeline's."""
    _, variables = _weights()
    _blob(str(tmp_path / "params"), variables)
    config = _config()
    out = io.StringIO()
    serve_ldm.serve(config, io.StringIO('{"prompt": "a red fox", "seed": 3, "out": "v"}'),
                    out, output_dir=str(tmp_path), device="cpu",
                    params_blob_path=str(tmp_path / "params"))
    resp = json.loads(out.getvalue().splitlines()[0])
    assert resp["ok"], resp
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer, packed_cfg_token_ids

    models = (load_params(factory.build_cond_model(config), variables[0]),
              load_params(factory.build_unet(config), variables[1]),
              load_params(factory.build_autoencoder(config, "vq", resolution=IMG),
                          variables[2]))
    assert isinstance(models[2], tm.AutoencoderVQ)
    ids = packed_cfg_token_ids(load_tokenizer(VOCAB), ["a red fox"] * 2, [""] * 2, 8)
    images, _ = cli.sample_txt2img(*models, factory.build_schedule(config),
                                   torch.as_tensor(ids), (2, 8, 8, 4),
                                   guidance_scale=torch.full((2, 1, 1, 1), 5.0), seed=3,
                                   device="cpu")
    np.testing.assert_array_equal(np.load(resp["out"]),
                                  cli.tensor_to_image(images.numpy()))


def test_ldm_trainer_encodes_vq_like_jax(tmp_path):
    """One LDM train step on the VQ autoencoder's latents (only_encode, no
    posterior draw) against the JAX step, and the CLI's model loading of a
    VQ blob."""
    from ldm_tf2_tpu.training.ldm_trainer import (
        init_ldm_train_state, make_ldm_train_step, make_optimizer,
    )
    from ldm_tf2_tpu_torch.cli import run_ldm_trainer
    from ldm_tf2_tpu_torch.training import ldm_trainer as tt

    (tr, un, ae), (trv, unv, aev) = _weights()
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(100, 2000, (2, 8)).astype(np.int32)

    def encode_latents(params, x, key):
        return ae.apply({"params": params}, x, only_encode=True,
                        method=jm.AutoencoderVQ.encode)

    jopt = make_optimizer(learning_rate=1e-4)
    jstep = jax.jit(make_ldm_train_step(
        lambda p, xt, t, c, rngs, training: un.apply({"params": p}, xt, t, c,
                                                     training=training, rngs=rngs),
        lambda p, i, rngs, training: tr.apply({"params": p}, i, training=training,
                                              rngs=rngs),
        encode_latents, jax_make_schedule(num_steps=100, num_ddim_steps=10), jopt,
        condition_dropout_rate=0.0))
    jstate = init_ldm_train_state(unv["params"], trv["params"], jopt)
    jstate, jm_ = jstep(jstate, aev["params"], jnp.asarray(images), jnp.asarray(ids),
                        jax.random.PRNGKey(7))
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    t_key, _, _, noise_key, _ = jax.random.split(key, 5)
    draws = {"t": torch.tensor(np.asarray(jax.random.randint(t_key, (2,), 0, 100))).long(),
             "noise": torch.tensor(np.asarray(jax.random.normal(noise_key, (2, 8, 8, 4))))}

    cond = load_params(tm.TransformerModel(**TR), trv)
    unet = load_params(tm.UNet(**UNET, context_channels=64), unv).requires_grad_(True)
    vq = load_params(tm.AutoencoderVQ(**VQ, resolution=IMG), aev).requires_grad_(False)
    cond.requires_grad_(False)
    opt = tt.make_optimizer(learning_rate=1e-4)
    step = tt.make_ldm_train_step(unet, cond, vq, make_schedule(num_steps=100,
                                                                num_ddim_steps=10),
                                  opt, condition_dropout_rate=0.0, seed=7)
    state = tt.init_ldm_train_state(unet, cond, opt)
    state, metrics = step(state, torch.as_tensor(images), torch.as_tensor(ids).long(), draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm_["loss"]), rtol=1e-5)

    # the CLI's loader builds the VQ autoencoder from a blob
    _blob(str(tmp_path / "params"), (trv, unv, aev))
    config = _config()
    config["ldm_training"] = dict(root_path=None, params=dict(batch_size=2, image_size=IMG),
                                  autoencoder_type="vq", ckpt_path=None, num_iterations=1,
                                  train_cond_model=False, condition_dropout_rate=0.0)
    config = validate(config)
    _, mesh, params = run_ldm_trainer.data_parallel_setup(config, "ldm_training", "cpu")
    assert dict(mesh.shape) == {"data": 1} and params["batch_size"] == 2
    _, _, loaded = run_ldm_trainer._load_models(config, str(tmp_path / "params"), "cpu", 0)
    assert isinstance(loaded, tm.AutoencoderVQ)
    for name, p in loaded.state_dict().items():
        torch.testing.assert_close(p, vq.state_dict()[name], rtol=0, atol=0)
