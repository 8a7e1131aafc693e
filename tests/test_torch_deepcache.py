"""The port's DeepCache against the JAX package's, on the CPU in float32.

The U-Net's full pass with ``return_cache`` and its shallow pass
(``models/unet.py``), at three and four levels with two residual blocks a
level, on one set of weights drawn by ``golden_utils.materialize`` and
carried across by the bridge; the DDIM and DPM-Solver++(2M) DeepCache
loops (``diffusion/sampler.py``, ``diffusion/solvers.py``) on a cheap
stand-in U-Net whose shallow pass reads the cache, so a full or shallow
step at the wrong index changes the result; and the sampler CLI's DeepCache
branch on a blob the JAX package exported.  The JAX loops' key splits are
replayed and handed to the port's loops.  Port vs JAX at rtol 1e-4 / atol
1e-5 (summation order only); within the port, a shallow pass fed a fresh
cache and ``cache_interval=1`` are bit-equal to the plain path.
"""

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
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion import solvers as tsolvers
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "bert_model")
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 8, 8, 4)


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ U-Net --

def _unet_kwargs(levels):
    return dict(model_channels=32, out_channels=4, num_blocks=2,
                channel_mult=(1, 2, 4, 4)[:levels], num_heads=2,
                context_channels=32, dropout_rate=0.0)


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(81)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([17.0, 640.0], np.float32)
    ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
    return x, t, ctx


CACHE_CASES = {3: (1, 2), 4: (1, 3)}  # levels -> cache_levels


@pytest.fixture(scope="module")
def jax_unets(unet_inputs):
    """levels -> (weights, the JAX U-Net's output, {cache_levels: cache}),
    from one jitted full pass a level count: its ``return_cache`` at the
    first cache level, and each output block's result
    (``capture_intermediates``), of which the cache at ``cache_levels`` is
    the one before output block ``(levels - cache_levels) * 3``."""
    x, t, ctx = unet_inputs
    done = {}

    def get(levels):
        if levels in done:
            return done[levels]
        kwargs = _unet_kwargs(levels)
        unet = jm.UNet(**kwargs)
        variables = _variables_of(tm.UNet(**kwargs),
                                  gu.unet_order(2, kwargs["channel_mult"]),
                                  gu.SEED + levels)
        first = CACHE_CASES[levels][0]

        @jax.jit
        def run(variables, x, t, ctx):
            return unet.apply(variables, x, t, ctx, return_cache=True,
                              cache_levels=first, capture_intermediates=True,
                              mutable=["intermediates"])

        (out, cache), state = run(variables, x, t, ctx)
        blocks = state["intermediates"]
        caches = {k: np.asarray(
            blocks[f"output_block_{(levels - k) * 3 - 1}"]["__call__"][0])
            for k in CACHE_CASES[levels]}
        np.testing.assert_array_equal(np.asarray(cache), caches[first])
        done[levels] = (variables, np.asarray(out), caches)
        return done[levels]

    return get


@pytest.mark.parametrize("levels,cache_levels", [(3, 1), (3, 2), (4, 1), (4, 3)])
def test_shallow_pass_and_cache_match_jax(unet_inputs, jax_unets, levels, cache_levels):
    """A full pass's cache against the JAX U-Net's; the shallow pass fed it
    equals the full pass bit for bit (as the JAX package's shallow pass does,
    ``tests/test_deepcache.py``), so both match the JAX output."""
    variables, want_out, want_caches = jax_unets(levels)
    unet = load_params(tm.UNet(**_unet_kwargs(levels)), variables)
    args = [torch.as_tensor(a) for a in unet_inputs]
    with torch.no_grad():
        full = unet(*args)
        out, cache = unet(*args, return_cache=True, cache_levels=cache_levels)
        shallow = unet(*args, shallow_cache=cache, cache_levels=cache_levels)
    # at the boundary of level cache_levels - 1: the deeper level's width,
    # upsampled to this level's side
    side = 16 >> (cache_levels - 1)
    width = 32 * (1, 2, 4, 4)[cache_levels]
    assert tuple(cache.shape) == want_caches[cache_levels].shape == (2, side, side, width)
    np.testing.assert_allclose(cache.numpy(), want_caches[cache_levels], **TOL)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    assert torch.equal(out, full) and torch.equal(shallow, full)


def test_cache_arguments_are_checked_as_in_jax(unet_inputs):
    x, t, ctx = (torch.as_tensor(a) for a in unet_inputs)
    unet = tm.UNet(**_unet_kwargs(3))
    for bad in (0, 3):
        with pytest.raises(ValueError, match=rf"cache_levels must be in \[1, 2\], got {bad}"):
            unet(x, t, ctx, return_cache=True, cache_levels=bad)
        with pytest.raises(ValueError, match="cache_levels must be in"):
            unet(x, t, ctx, shallow_cache=torch.zeros(1), cache_levels=bad)
    with pytest.raises(ValueError, match="a shallow pass cannot produce a cache"):
        unet(x, t, ctx, shallow_cache=torch.zeros(1), return_cache=True)


# ------------------------------------------------------------------ loops --

@pytest.fixture(scope="module")
def cached_models():
    """(JAX full, JAX shallow, port full, port shallow, context): a stand-in
    U-Net ``tanh(x W1 + t/1000 u + mean(c) W2 + deep)``, whose full pass
    computes ``deep = tanh(x W3)`` and returns it as the cache and whose
    shallow pass reads the cache in its place."""
    rng = np.random.default_rng(83)
    w1, w3 = (rng.standard_normal((4, 4)).astype(np.float32) * 0.5 for _ in range(2))
    u = rng.standard_normal(4).astype(np.float32)
    w2 = rng.standard_normal((64, 4)).astype(np.float32) * 0.1
    context = rng.standard_normal((4, 5, 64)).astype(np.float32)

    def jbody(x, t, c, deep):
        return jnp.tanh(x @ w1 + (t / 1000.0)[:, None, None, None] * u
                        + (jnp.mean(c, axis=1) @ w2)[:, None, None, :] + deep)

    def jfull(x, t, c):
        deep = jnp.tanh(x @ w3)
        return jbody(x, t, c, deep), deep

    tw1, tw3, tu, tw2 = (torch.from_numpy(a) for a in (w1, w3, u, w2))

    def tbody(x, t, c, deep):
        return torch.tanh(x @ tw1 + (t / 1000.0)[:, None, None, None] * tu
                          + (c.mean(dim=1) @ tw2)[:, None, None, :] + deep)

    def tfull(x, t, c):
        deep = torch.tanh(x @ tw3)
        return tbody(x, t, c, deep), deep

    return jfull, jbody, tfull, tbody, context


def _replayed_draws(key, steps):
    """The DDIM DeepCache loop's draws: (key, init_key), then (key,
    step_key) once a step, in loop order."""
    key, init_key = jax.random.split(key)
    init = jax.random.normal(init_key, SHAPE, jnp.float32)
    noises = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        noises.append(jax.random.normal(step_key, SHAPE, jnp.float32))
    return np.asarray(init), np.stack([np.asarray(n) for n in noises])


def _schedules(steps, eta=0.0, **kw):
    """S = ``steps`` DDIM steps: 42 divides by 6 and 7."""
    kw = dict(num_steps=42, beta_start=0.00085, beta_end=0.012,
              num_ddim_steps=steps, eta=eta, **kw)
    return jax_make_schedule(**kw), make_schedule(**kw)


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("interval", [1, 2, 3])
@pytest.mark.parametrize("steps", [6, 7])
def test_ddim_deepcache_loop_matches_jax(cached_models, steps, interval, eta):
    jfull, jshallow, tfull, tshallow, context = cached_models
    jschedule, schedule = _schedules(steps, eta)
    key = jax.random.PRNGKey(steps * 10 + interval)

    with jax.disable_jit():  # op by op: the ops compile once for every case
        want = np.asarray(jsampler.ddim_sample_loop_deepcache(
            jfull, jshallow, jschedule, jnp.asarray(context), SHAPE, key, 5.0,
            cache_interval=interval))
    init, noises = _replayed_draws(key, len(schedule.ddim_steps))
    hooks = dict(guidance_scale=5.0, init_noise=_t(init), step_noises=_t(noises))
    with torch.no_grad():
        got = tsampler.ddim_sample_loop_deepcache(
            tfull, tshallow, schedule, _t(context), SHAPE, cache_interval=interval,
            **hooks)
        plain = tsampler.ddim_sample_loop(lambda x, t, c: tfull(x, t, c)[0], schedule,
                                          _t(context), SHAPE, **hooks)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # interval 1 is the plain loop; a longer one reuses stale caches
    assert torch.equal(got, plain) == (interval == 1)


@pytest.mark.parametrize("interval", [1, 2, 3])
@pytest.mark.parametrize("steps", [6, 7])
def test_dpm_deepcache_loop_matches_jax(cached_models, steps, interval):
    jfull, jshallow, tfull, tshallow, context = cached_models
    jschedule, schedule = _schedules(steps, timestep_spacing="karras")
    init = np.random.default_rng(steps).standard_normal(SHAPE).astype(np.float32)

    with jax.disable_jit():
        want = np.asarray(jsolvers.dpm_solver_pp_2m_sample_loop_deepcache(
            jfull, jshallow, jschedule, jnp.asarray(context), SHAPE,
            jax.random.PRNGKey(0), 5.0, cache_interval=interval,
            init_noise=jnp.asarray(init)))
    with torch.no_grad():
        got = tsolvers.dpm_solver_pp_2m_sample_loop_deepcache(
            tfull, tshallow, schedule, _t(context), SHAPE, guidance_scale=5.0,
            cache_interval=interval, init_noise=_t(init))
        plain = tsolvers.dpm_solver_pp_2m_sample_loop(
            lambda x, t, c: tfull(x, t, c)[0], schedule, _t(context), SHAPE,
            guidance_scale=5.0, init_noise=_t(init))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, plain) == (interval == 1)


@pytest.mark.parametrize("steps,interval,want", [
    (7, 3, "FSSFSSF"),  # two groups of 3, a tail of 1 based at index 0
    (7, 2, "FSFSFSF"),
    (8, 3, "FSSFSSFS"),  # a tail of 2 based at index 1
])
def test_deepcache_schedule_follows_the_jax_groups(steps, interval, want):
    calls = []

    def full(*args):
        calls.append("F")
        return None, None

    model = tsampler.deepcache_model(full, lambda *args: calls.append("S"), interval)
    for _ in range(steps):
        model(None, None, None)
    assert "".join(calls) == want


# -------------------------------------------------------------------- CLI --

def test_cli_deepcache_matches_sample_txt2img(tmp_path, monkeypatch, jax_unets):
    """``cache_interval: 2`` with DPM-Solver++(2M) and three U-Net levels
    (``cache_levels: 2``) through ``main`` on a JAX-exported blob (the
    three-level U-Net's weights above): the same images as
    ``sample_txt2img`` with the same seed and cache."""
    tr = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=32, num_heads=2,
              size_per_head=16, max_seq_len=8, filter_size=64, dropout_rate=0.0)
    unet_kw = _unet_kwargs(3)
    ae = dict(channels=32, num_blocks=1, multipliers=(1, 2))
    export_blob(str(tmp_path / "params"), {
        "cond_stage_model": _variables_of(tm.TransformerModel(**tr),
                                          gu.transformer_order(1), gu.SEED + 91)["params"],
        "unet": jax_unets(3)[0]["params"],
        "autoencoder": _variables_of(tm.AutoencoderKL(**ae),
                                     gu.autoencoder_kl_order(1, (1, 2), 16),
                                     gu.SEED + 93)["params"],
    })
    config = {
        "cond_stage_model": tr,
        "unet": {**{k: v for k, v in unet_kw.items() if k != "context_channels"},
                 "channel_mult": list(unet_kw["channel_mult"]),
                 "attention_resolutions": [1]},
        "autoencoder_kl": dict(latent_channels=4, attention_resolutions=[],
                               dropout_rate=0.0, resample_with_conv=True,
                               channels=32, num_blocks=1, multipliers=[1, 2]),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=0.0, num_ddim_steps=5),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=list(SHAPE),
                             text_prompt="a red fox", vocab_dir=VOCAB,
                             autoencoder_type="kl", sampler="dpm_solver_pp_2m",
                             cache_interval=2, cache_levels=2),
        "tpu": {"compute_dtype": "float32"},
    }
    (tmp_path / "config.json").write_text(json.dumps(config))  # JSON is YAML
    monkeypatch.chdir(tmp_path)
    cli.main(["--config_path", str(tmp_path / "config.json"), "--params_blob",
              str(tmp_path / "params"), "--seed", "3", "--device", "cpu"])

    from ldm_tf2_tpu_torch.configs.loader import validate

    config = validate(config)
    blob = read_blob(str(tmp_path / "params"))
    models = (load_params(factory.build_cond_model(config), blob["cond_stage_model"]),
              load_params(factory.build_unet(config), blob["unet"]),
              load_params(factory.build_autoencoder(config, "kl"), blob["autoencoder"]))
    ids = torch.as_tensor(cfg_token_ids(load_tokenizer(VOCAB), "a red fox", 2, 8))
    schedule = factory.build_schedule(config)
    kw = dict(sampler="dpm_solver_pp_2m", guidance_scale=5.0, seed=3, device="cpu")
    images, x0 = cli.sample_txt2img(*models, schedule, ids, SHAPE, cache_interval=2,
                                    cache_levels=2, **kw)
    np.testing.assert_array_equal(np.load(tmp_path / "images.npy"),
                                  cli.tensor_to_image(images.numpy()))
    _, x0_plain = cli.sample_txt2img(*models, schedule, ids, SHAPE, **kw)
    assert not torch.equal(x0, x0_plain)  # the shallow steps ran
