"""The port's sampler menu against the JAX package's loops.

PLMS and DPM-Solver++(2M) (``diffusion/solvers.py``) under every timestep
spacing, the progressive DDIM loop and ancestral DDPM
(``diffusion/sampler.py``), each driving the same one-layer eps model on
both sides with the same initial latent.  Where a JAX loop draws noise from
its key, the test replays the key splits with ``jax.random`` and hands the
draws to the port's loop (``init_noise``, ``step_noises``).  float32 on
both sides, held at the pipeline tests' rtol 1e-4 / atol 1e-5 (summation
order only).  Then the CLI's ``sampler`` table and ``sample_save_progress``
files, the server with a non-DDIM sampler, and the branches still refused.
"""

import io
import json
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
from ldm_tf2_tpu.diffusion import solvers as jsolvers
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.cli import serve_ldm
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer, packed_cfg_token_ids
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion import solvers as tsolvers
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "bert_model")
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, context_channels=64, dropout_rate=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 8, 8, 4)


def _variables(init, order, seed):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool slows this file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unets():
    """(JAX eps model, port eps model, context as numpy) on one set of
    weights: a one-layer stand-in for the U-Net, ``tanh(x W1 + t/1000 u +
    mean(context) W2)``, cheap to compile, so the tests time the loops (the
    U-Net is held to JAX's in ``test_torch_models.py``)."""
    rng = np.random.default_rng(61)
    w1 = rng.standard_normal((4, 4)).astype(np.float32) * 0.5
    u = rng.standard_normal(4).astype(np.float32)
    w2 = rng.standard_normal((64, 4)).astype(np.float32) * 0.1
    context = rng.standard_normal((4, 5, 64)).astype(np.float32)

    def jeps(x, t, c):
        cond = jnp.mean(c, axis=1) @ w2
        return jnp.tanh(x @ w1 + (t / 1000.0)[:, None, None, None] * u
                        + cond[:, None, None, :])

    tw1, tu, tw2 = (torch.from_numpy(a) for a in (w1, u, w2))

    def teps(x, t, c):
        cond = c.mean(dim=1) @ tw2
        return torch.tanh(x @ tw1 + (t / 1000.0)[:, None, None, None] * tu
                          + cond[:, None, None, :])

    return jeps, teps, context


def _schedules(**kw):
    kw = dict(num_steps=50, beta_start=0.00085, beta_end=0.012, **kw)
    return jax_make_schedule(**kw), make_schedule(**kw)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


@pytest.mark.parametrize("spacing", ["uniform", "trailing", "karras"])
@pytest.mark.parametrize("loop", ["plms_sample_loop", "dpm_solver_pp_2m_sample_loop"])
def test_solvers_match_jax(unets, loop, spacing):
    eps, unet, context = unets
    jschedule, schedule = _schedules(num_ddim_steps=6, timestep_spacing=spacing)
    init = np.random.default_rng(63).standard_normal(SHAPE).astype(np.float32)

    @jax.jit
    def run(context, init):
        return getattr(jsolvers, loop)(eps, jschedule, context, SHAPE,
                                       jax.random.PRNGKey(0), 5.0, init_noise=init)

    want = np.asarray(run(jnp.asarray(context), jnp.asarray(init)))
    with torch.no_grad():
        got = getattr(tsolvers, loop)(unet, schedule, _t(context), SHAPE,
                                      guidance_scale=5.0, init_noise=_t(init))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(np.abs(want - init).max()) > 0.1  # the loop moved the latent


def _replayed_draws(key, shape, steps):
    """The draws of a JAX loop that splits (key, init_key), then (key,
    step_key) once a step and draws ``normal(step_key, shape)``."""
    key, init_key = jax.random.split(key)
    init = jax.random.normal(init_key, shape, jnp.float32)
    noises = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        noises.append(jax.random.normal(step_key, shape, jnp.float32))
    return np.asarray(init), np.stack([np.asarray(n) for n in noises])


def test_progressive_ddim_records_match_jax(unets):
    eps, unet, context = unets
    jschedule, schedule = _schedules(num_ddim_steps=10, eta=1.0)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def run(context):
        return jsampler.ddim_sample_loop_progressive(
            eps, jschedule, context, SHAPE, key, 5.0, record_freq=3)

    want = [np.asarray(a) for a in run(jnp.asarray(context))]
    init, noises = _replayed_draws(key, SHAPE, 10)
    with torch.no_grad():
        got = tsampler.ddim_sample_loop_progressive(
            unet, schedule, _t(context), SHAPE, guidance_scale=5.0, record_freq=3,
            init_noise=_t(init), step_noises=_t(noises))
    assert got[1].shape == got[2].shape == (2, 3, 8, 8, 4)  # 10 // 3 records
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # record r holds DDIM index 3r; the last, index 0, is x0 itself
    with torch.no_grad():
        x0, traj = tsampler.ddim_sample_loop(
            unet, schedule, _t(context), SHAPE, guidance_scale=5.0,
            init_noise=_t(init), step_noises=_t(noises), return_trajectory=True)
    np.testing.assert_array_equal(got[1].numpy(), traj.numpy()[[9, 6, 3]].swapaxes(0, 1))
    np.testing.assert_array_equal(got[0].numpy(), x0.numpy())


def test_ddpm_with_replayed_keys_matches_jax(unets):
    eps, unet, context = unets
    jschedule = jax_make_schedule(num_steps=12, beta_start=0.00085, beta_end=0.012,
                                  num_ddim_steps=4)
    schedule = make_schedule(num_steps=12, beta_start=0.00085, beta_end=0.012,
                             num_ddim_steps=4)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def run(context):
        return jsampler.ddpm_sample_loop(eps, jschedule, context, SHAPE, key, 5.0)

    want = np.asarray(run(jnp.asarray(context)))
    init, noises = _replayed_draws(key, SHAPE, 12)
    with torch.no_grad():
        got = tsampler.ddpm_sample_loop(unet, schedule, _t(context), SHAPE,
                                        guidance_scale=5.0, init_noise=_t(init),
                                        step_noises=_t(noises))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ CLI, server --

TR = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64, num_heads=2,
          size_per_head=32, max_seq_len=8, filter_size=128, dropout_rate=0.0)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))


def _config(steps=5, **sampling):
    return {
        "cond_stage_model": dict(TR),
        "unet": {**{k: v for k, v in UNET.items() if k != "context_channels"},
                 "attention_resolutions": [1]},
        "autoencoder_kl": dict(latent_channels=4, attention_resolutions=[],
                               dropout_rate=0.0, resample_with_conv=True, **AE),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012,
                    v_posterior=0.0, scale_factor=0.18215, eta=0.0,
                    num_ddim_steps=steps),
        "ldm_sampling": {**dict(guidance_scale=5.0, latent_shape=list(SHAPE),
                                text_prompt="a red fox", vocab_dir=VOCAB,
                                autoencoder_type="kl"), **sampling},
        "tpu": {"compute_dtype": "float32"},
    }


def _run_cli(tmp_path, monkeypatch, steps=5, **sampling):
    key = jax.random.PRNGKey(0)
    tr, un, ae = jm.TransformerModel(**TR), jm.UNet(**UNET), jm.AutoencoderKL(**AE)
    export_blob(str(tmp_path / "params"), {
        "cond_stage_model": _variables(
            lambda: tr.init(key, jnp.zeros((2, 8), jnp.int32)),
            gu.transformer_order(1), gu.SEED + 71)["params"],
        "unet": _variables(
            lambda: un.init(key, jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
                            jnp.zeros((2, 8, 64))),
            gu.unet_order(1, (1, 2)), gu.SEED + 72)["params"],
        "autoencoder": _variables(
            lambda: ae.init({"params": key, "sample": key}, jnp.zeros((1, 16, 16, 3))),
            gu.autoencoder_kl_order(1, (1, 2), 16), gu.SEED + 73)["params"],
    })
    path = tmp_path / "config.json"  # JSON is YAML
    path.write_text(json.dumps(_config(steps, **sampling)))
    monkeypatch.chdir(tmp_path)
    cli.main(["--config_path", str(path), "--params_blob", str(tmp_path / "params"),
              "--device", "cpu"])


def test_cli_sample_save_progress_writes_the_jax_files(tmp_path, monkeypatch):
    _run_cli(tmp_path, monkeypatch, steps=10, sample_save_progress=True)
    images = np.load(tmp_path / "images.npy")
    assert images.shape == (2, 16, 16, 3) and images.dtype == np.uint8
    for name in ("sample_prog.npy", "pred_x0_prog.npy"):
        prog = np.load(tmp_path / name)
        # 10 DDIM steps, every 5th recorded; per-image min-max over records
        assert prog.shape == (2, 2, 16, 16, 3) and prog.dtype == np.uint8, name
        assert prog.reshape(2, -1).min(axis=1).tolist() == [0, 0], name
        assert prog.reshape(2, -1).max(axis=1).tolist() == [255, 255], name
    # the last record (DDIM index 0) is the final sample, decoded
    sample_prog = np.load(tmp_path / "sample_prog.npy")
    assert not np.array_equal(sample_prog[:, 0], sample_prog[:, 1])


def test_cli_runs_a_solver_and_checks_the_table(tmp_path, monkeypatch):
    _run_cli(tmp_path, monkeypatch, sampler="dpm_solver_pp_2m")
    images = np.load(tmp_path / "images.npy")
    assert images.shape == (2, 16, 16, 3) and images.dtype == np.uint8
    assert sorted(cli.SAMPLE_LOOPS) == ["ddim", "ddpm", "dpm_solver_pp_2m", "plms"]
    with pytest.raises(ValueError, match="must be one of"):
        cli.sampler_name({"sampler": "euler"})
    config = tmp_path / "bad.json"
    config.write_text(json.dumps(_config(sampler="plms", sample_save_progress=True)))
    with pytest.raises(ValueError, match="only supports sampler: ddim"):
        cli.main(["--config_path", str(config), "--params_blob", "unused",
                  "--device", "cpu"])


def test_server_answers_with_a_non_ddim_sampler(tmp_path, monkeypatch):
    config = validate(_config(2, sampler="plms"))
    models = tuple(
        factory.randomize_(build(config, device="cpu"), seed)
        for seed, build in ((1, factory.build_cond_model), (2, factory.build_unet),
                            (3, factory.build_autoencoder)))
    samplers = []
    real = serve_ldm.sample_txt2img

    def recording(*args, **kwargs):
        samplers.append(kwargs["sampler"])
        return real(*args, **kwargs)

    monkeypatch.setattr(serve_ldm, "sample_txt2img", recording)
    out = io.StringIO()
    serve_ldm.serve(config, io.StringIO('{"prompt": "a red fox", "seed": 5, "out": "p"}'),
                    out, output_dir=str(tmp_path), device="cpu", models=models)
    resp = json.loads(out.getvalue().splitlines()[0])
    assert resp["ok"] and resp["shape"] == [2, 16, 16, 3]
    assert samplers == ["plms", "plms"]  # the warm-up and the request
    ids = packed_cfg_token_ids(load_tokenizer(VOCAB), ["a red fox"] * 2, [""] * 2, 8)
    images, _ = real(*models, factory.build_schedule(config), torch.as_tensor(ids),
                     SHAPE, sampler="plms",
                     guidance_scale=torch.full((2, 1, 1, 1), 5.0), seed=5, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  cli.tensor_to_image(images.numpy()))


@pytest.mark.parametrize("sampling,tpu,what", [
    ({"cache_interval": 2}, {}, "DeepCache .* item A1"),
    ({"sampler": "dpm_solver_pp_2m", "cache_interval": 2}, {}, "DeepCache .* item A1"),
    ({"init_image_path": "init.npy"}, {}, "img2img .* item A1"),
    ({"mask_path": "mask.npy"}, {}, "inpainting .* item A1"),
    ({}, {"tensor_parallel": True}, "item A6"),
])
def test_remaining_branches_still_name_their_items(sampling, tpu, what):
    config = _config(**sampling)
    config["tpu"].update(tpu)
    config = validate(config)
    with pytest.raises(NotImplementedError, match=what):
        cli.check_supported(config)
    if "init_image_path" not in sampling and "mask_path" not in sampling:
        with pytest.raises(NotImplementedError, match=what):
            serve_ldm.build_server(config, device="cpu", models=())
