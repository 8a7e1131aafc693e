"""The port's training slice against the JAX package's, on the CPU.

Tiny models as ``tests/test_trainers.py::tiny_ldm`` builds them, weights
drawn with numpy as flax initializes them, the same weights through the
port's bridge.  (``golden_utils.materialize``'s N(0, 1) * 0.05 weights put
GroupNorm scales near 0, where the float32 gradient of the fast variance
is cancellation noise in either framework.)  Each
JAX train step is jitted once per variant and module.

Tolerances (float32 throughout, except the one bf16-compute run):
* U-Net loss and gradients at dropout 0 against ``jax.grad``, and those of
  the text encoder and U-Net together with every dropout site on (at a
  rate whose keep probability rounds to 1, so no element drops): only the
  summation order differs, rtol 1e-5 on the loss; gradients rtol 1e-4 with
  an atol of 1e-5 of the largest gradient entry.
* Three train steps against ``make_ldm_train_step`` on the same weights
  and injected draws: losses rtol 1e-5; every updated parameter (U-Net,
  text encoder when it trains, EMA) rtol 1e-5 / atol 1e-6, against moves
  of up to 3e-3 (the bf16-moment run's own bounds are stated beside it).
* bf16 compute: both frameworks round activations to bf16 at places of
  their own choosing (8 bits of mantissa): loss rtol 2e-2, the parameters'
  change within 0.1 rel-L2 of JAX's as a whole and 0.2 in each leaf
  (measured 0.040 and at most 0.086).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.models import AutoencoderKL, TransformerModel, UNet
from ldm_tf2_tpu.training.ldm_trainer import (
    init_ldm_train_state as jax_init_state,
    make_ldm_train_step as jax_make_step,
    make_optimizer as jax_make_optimizer,
)
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, params_from_jax
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.models.layers import dropout
from ldm_tf2_tpu_torch.training import ldm_trainer as tt

IMG = 16
# model_channels 64, not tiny_ldm's 32: with one channel per GroupNorm
# group, the level-0 conv biases and time projections have a gradient of
# exactly 0, which both frameworks return as rounding noise and Adam
# scales to full-size updates of opposite signs.
UNET = dict(model_channels=64, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, context_channels=32)
COND = dict(vocab_size=64, encoder_stack_size=1, hidden_size=32, num_heads=2,
            size_per_head=8, max_seq_len=8, filter_size=64)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))
NULL_IDS = np.array([2, 3] + [0] * 6, np.int32)
SEED = 7
# Dropout on in training mode, yet every element kept: 1 - 1e-9 rounds to
# 1 in float32, so the masks are all ones and the scale is 1 in both
# frameworks, and each dropout site's own code path runs.
KEEP_ALL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool makes this file 1.6x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init_like_flax(init, seed):
    """Weights in the init's tree drawn with numpy as flax's initializers
    draw them (lecun-normal kernels over all input dims; the split
    projections' over D), with norm scales 1 + N(0, 0.1) and biases
    N(0, 0.02) so that their gradients are exercised too; the init itself
    is not run (eager flax init of the three models takes a minute here)."""
    gen = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * gen.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.02 * gen.standard_normal(s.shape)).astype(np.float32)
        split = len(s.shape) == 3 and path[-2].key in ("query", "key", "value")
        fan_in = s.shape[0] if split else int(np.prod(s.shape[:-1]))
        return (gen.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))["params"]


@functools.lru_cache(maxsize=None)
def _jax_params():
    key = jax.random.PRNGKey(0)
    unet = UNet(**UNET, dropout_rate=0.0)
    cond = TransformerModel(**COND, dropout_rate=0.0)
    ae = AutoencoderKL(**AE)
    up = _init_like_flax(lambda: unet.init(key, jnp.zeros((2, IMG // 2, IMG // 2, 4)),
                                           jnp.zeros((2,)), jnp.zeros((2, 8, 32))), 1)
    cp = _init_like_flax(lambda: cond.init(key, jnp.zeros((2, 8), jnp.int32)), 2)
    ap = _init_like_flax(lambda: ae.init({"params": key, "sample": key},
                                         jnp.zeros((2, IMG, IMG, 3))), 3)
    return up, cp, ap


def _port_models(dtype=torch.float32, rate=0.0):
    up, cp, ap = _jax_params()
    unet = load_params(tm.UNet(**UNET, dropout_rate=rate, dtype=dtype), up)
    cond = load_params(tm.TransformerModel(**COND, dropout_rate=rate, dtype=dtype), cp)
    ae = load_params(tm.AutoencoderKL(**AE, dtype=dtype), ap)
    return cond, unet, ae


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(4, 64, (2, 8)).astype(np.int32)
    return images, ids


# ------------------------------------------------------- U-Net gradients --

def test_unet_loss_and_gradients_match_jax_grad():
    up = _jax_params()[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, IMG // 2, IMG // 2, 4)).astype(np.float32)
    t = np.array([3.0, 71.0], np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    jax_unet = UNet(**UNET, dropout_rate=0.0)

    def jax_loss(params):
        out = jax_unet.apply({"params": params}, x, t, ctx, training=True)
        return jnp.mean(jnp.mean((target - out) ** 2, axis=(1, 2, 3)))

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(up)
    unet = _port_models()[1].requires_grad_(True)
    out = unet(*(torch.as_tensor(a) for a in (x, t, ctx)), training=True)
    got = ((torch.as_tensor(target) - out) ** 2).mean(dim=(1, 2, 3)).mean()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _assert_grads_close(got, unet, grads, "unet")


def _assert_grads_close(loss, module, jax_grads, what):
    """The port's gradients of ``loss`` with respect to ``module``'s
    parameters against JAX's tree: rtol 1e-4, atol 1e-5 of the largest."""
    names, params = zip(*module.named_parameters())
    got_grads = torch.autograd.grad(loss, params, retain_graph=True)
    want = params_from_jax(jax.tree.map(np.asarray, jax_grads))
    assert set(want) == set(names), what
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, got_grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=f"{what} {name}")


def test_dropout_sites_match_jax_grad():
    """Training mode with dropout on in the text encoder and the U-Net at
    ``KEEP_ALL``: the U-Net's split ResidualBlock chain (GN+SiLU, dropout,
    conv, shortcut + h), the attention output dropout and the encoder's
    embedding, attention, FFN and residual dropout all run in both
    frameworks; the loss and both models' gradients equal jax.grad's."""
    up, cp, _ = _jax_params()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, IMG // 2, IMG // 2, 4)).astype(np.float32)
    t = np.array([17.0, 90.0], np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    ids = _batch()[1]
    jax_unet = UNet(**UNET, dropout_rate=KEEP_ALL)
    jax_cond = TransformerModel(**COND, dropout_rate=KEEP_ALL)

    def jax_loss(params):
        k_cond, k_unet = jax.random.split(jax.random.PRNGKey(0))
        ctx = jax_cond.apply({"params": params["cond"]}, ids, training=True,
                             rngs={"dropout": k_cond})
        out = jax_unet.apply({"params": params["unet"]}, x, t, ctx, training=True,
                             rngs={"dropout": k_unet})
        return jnp.mean(jnp.mean((target - out) ** 2, axis=(1, 2, 3)))

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))({"unet": up, "cond": cp})
    cond, unet, _ = _port_models(rate=KEEP_ALL)
    cond.requires_grad_(True)
    unet.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    drawn = gen.get_state()
    ctx = cond(torch.as_tensor(ids).long(), training=True, generator=gen)
    assert not torch.equal(gen.get_state(), drawn)  # the encoder drew masks
    drawn = gen.get_state()
    out = unet(torch.as_tensor(x), torch.as_tensor(t), ctx, training=True, generator=gen)
    assert not torch.equal(gen.get_state(), drawn)  # and so did the U-Net
    got = ((torch.as_tensor(target) - out) ** 2).mean(dim=(1, 2, 3)).mean()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _assert_grads_close(got, unet, grads["unet"], "unet")
    _assert_grads_close(got, cond, grads["cond"], "cond")


def test_dropout_rate_scale_and_generator():
    x = torch.ones(200_000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_unet_training_mode_masks_follow_the_generator():
    """Dropout 0.5: one generator seed gives one set of masks (the same
    output twice), another seed another; training=False is bit-equal to
    the sampling path of the same weights with dropout off."""
    up = _jax_params()[0]
    unet = load_params(tm.UNet(**UNET, dropout_rate=0.5), up)
    plain = load_params(tm.UNet(**UNET, dropout_rate=0.0), up)
    rng = np.random.default_rng(4)
    x, ctx = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
              for s in ((2, IMG // 2, IMG // 2, 4), (2, 8, 32)))
    t = torch.tensor([3.0, 71.0])
    with torch.no_grad():
        a = unet(x, t, ctx, training=True, generator=torch.Generator().manual_seed(1))
        b = unet(x, t, ctx, training=True, generator=torch.Generator().manual_seed(1))
        c = unet(x, t, ctx, training=True, generator=torch.Generator().manual_seed(2))
        off = unet(x, t, ctx, training=False, generator=torch.Generator().manual_seed(1))
        ref = plain(x, t, ctx)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, ref) and not torch.equal(a, ref)
    with pytest.raises(ValueError, match="generator"):
        unet(x, t, ctx, training=True)


def test_text_encoder_training_mode_follows_the_generator():
    cp = _jax_params()[1]
    cond = load_params(tm.TransformerModel(**COND, dropout_rate=0.3), cp)
    ids = torch.as_tensor(_batch()[1]).long()
    with torch.no_grad():
        a = cond(ids, training=True, generator=torch.Generator().manual_seed(5))
        b = cond(ids, training=True, generator=torch.Generator().manual_seed(5))
        off = cond(ids)
    assert torch.equal(a, b) and not torch.equal(a, off)


# ------------------------------------------------------ train-step parity --

# Each run compiles one JAX step (about 20 s here), so the variants share
# runs: every option of make_optimizer and of the step is on in one of them.
# epsilon 1e-3 (not 1e-8) keeps Adam's division well conditioned: with
# 1e-8, an element whose gradient is rounding noise moves by about lr in a
# direction the noise picks, in either framework.
_OPT = dict(learning_rate=1e-3, epsilon=1e-3)
VARIANTS = {
    "adamw": dict(opt=_OPT),
    # a bf16 first moment that lies on a rounding midpoint in one framework
    # and not the other moves that element's update by 2^-8 of its size:
    # loss rtol 3e-5, parameters atol 1e-5 (measured 1.0e-5 and 2.5e-6)
    "warmup_cosine_clip_mu_bf16": dict(opt=dict(
        _OPT, warmup_steps=1, decay_steps=3, clip_grad_norm=0.05,
        mu_dtype="bfloat16"), loss_rtol=3e-5, atol=1e-5),
    # and every dropout site of both models on at KEEP_ALL
    "accum2_ema_train_cond_chunks2": dict(opt=_OPT, accum=2, ema=0.9,
                                          train_cond=True, chunks=2, rate=KEEP_ALL),
}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draw_arrays(step, b, latent_shape, chunks, dtype, num_steps=100, rate=0.1):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    t_key, latent_key, drop_key, noise_key, _ = jax.random.split(rng, 5)
    t = jax.random.randint(t_key, (b,), 0, num_steps)
    if chunks == 1:
        post = jax.random.normal(latent_key, latent_shape, dtype)
    else:
        part = (b // chunks,) + latent_shape[1:]
        post = jnp.concatenate([jax.random.normal(k, part, dtype)
                                for k in jax.random.split(latent_key, chunks)])
    drop = jax.random.bernoulli(drop_key, rate, (b,))
    noise = jax.random.normal(noise_key, latent_shape, dtype)
    return t, post.astype(jnp.float32), drop, noise.astype(jnp.float32)


def _jax_draws(step, b, latent_shape, chunks, dtype):
    """The JAX step's draws at ``step``: fold_in(PRNGKey(SEED), step), split
    in five, then exactly the calls of make_ldm_train_step (posterior and
    noise in the compute dtype, as the latents are)."""
    t, post, drop, noise = (np.asarray(a) for a in _jax_draw_arrays(
        step, b, latent_shape, chunks, dtype))
    return {"t": torch.tensor(t).long(), "posterior_noise": torch.tensor(post),
            "drop": torch.tensor(drop), "noise": torch.tensor(noise)}


def _run_variant(variant, compute=jnp.float32, tdtype=torch.float32, steps=3):
    opt_kw = variant["opt"]
    accum = variant.get("accum", 1)
    ema = variant.get("ema")
    train_cond = variant.get("train_cond", False)
    chunks = variant.get("chunks", 1)
    rate = variant.get("rate", 0.0)
    up, cp, ap = _jax_params()
    unet = UNet(**UNET, dropout_rate=rate, dtype=compute)
    cond = TransformerModel(**COND, dropout_rate=rate, dtype=compute)
    ae = AutoencoderKL(**AE, dtype=compute)

    def unet_apply(params, xt, t, ctx, rngs, training):
        return unet.apply({"params": params}, xt, t, ctx, training=training, rngs=rngs)

    def cond_apply(params, ids, rngs, training):
        return cond.apply({"params": params}, ids, training=training, rngs=rngs)

    def encode_latents(params, images, key):
        post = ae.apply({"params": params}, images, method=AutoencoderKL.encode)
        return post.sample(key)

    schedule = jax_make_schedule(num_steps=100, num_ddim_steps=10)
    jopt = jax_make_optimizer(**opt_kw, accum_steps=accum)
    jstep = jax.jit(jax_make_step(
        unet_apply, cond_apply, encode_latents, schedule, jopt,
        condition_dropout_rate=0.1, train_cond_model=train_cond,
        null_token_ids=jnp.asarray(NULL_IDS), ema_decay=ema, encode_chunks=chunks))
    jstate = jax_init_state(up, cp, jopt, train_cond_model=train_cond, ema_decay=ema)
    images, ids = _batch()
    jimages = jnp.asarray(images, compute)
    jlosses = []
    for _ in range(steps):
        jstate, m = jstep(jstate, ap, jimages, jnp.asarray(ids), jax.random.PRNGKey(SEED))
        jlosses.append(float(m["loss"]))

    cond_m, unet_m, ae_m = _port_models(tdtype, rate)
    unet_m.float().requires_grad_(True)
    if train_cond:
        cond_m.float().requires_grad_(True)
    opt = tt.make_optimizer(**opt_kw, accum_steps=accum)
    step = tt.make_ldm_train_step(
        unet_m, cond_m, ae_m, make_schedule(num_steps=100, num_ddim_steps=10), opt,
        condition_dropout_rate=0.1, train_cond_model=train_cond,
        null_token_ids=NULL_IDS, ema_decay=ema, encode_chunks=chunks, seed=SEED)
    state = tt.init_ldm_train_state(unet_m, cond_m, opt, train_cond, ema)
    timages = torch.as_tensor(images).to(tdtype)
    latent_shape = (2, IMG // 2, IMG // 2, 4)
    losses = []
    for s in range(steps):
        draws = _jax_draws(s, images.shape[0], latent_shape, chunks, compute)
        state, m = step(state, timages, torch.as_tensor(ids).long(), draws)
        losses.append(float(m["loss"]))
    return jstate, jlosses, (cond_m, unet_m, state), losses


def _assert_tree_close(want_tree, got_state, rtol, atol, what):
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), want_tree))
    assert set(want) == set(got_state), what
    for name, w in want.items():
        np.testing.assert_allclose(got_state[name].detach().float().numpy(), w.numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_train_steps_match_jax(name):
    variant = VARIANTS[name]
    jstate, jlosses, (cond_m, unet_m, state), losses = _run_variant(variant)
    np.testing.assert_allclose(losses, jlosses, rtol=variant.get("loss_rtol", 1e-5))
    assert state.step == int(jstate.step) == 3
    atol = variant.get("atol", 1e-6)
    _assert_tree_close(jstate.unet_params, unet_m.state_dict(), 1e-5, atol, "unet")
    p0 = params_from_jax(_jax_params()[0])
    moved = max(float((p - p0[n]).abs().max()) for n, p in unet_m.state_dict().items())
    assert moved > 1e-4, moved
    if variant.get("train_cond"):
        _assert_tree_close(jstate.cond_params, cond_m.state_dict(), 1e-5, atol, "cond")
    else:
        _assert_tree_close(_jax_params()[1], cond_m.state_dict(), 0, 0, "frozen cond")
    if variant.get("ema"):
        for part in ("unet", "cond") if variant.get("train_cond") else ("unet",):
            ema = {k[len(part) + 1:]: v for k, v in state.ema.items()
                   if k.startswith(part + ".")}
            _assert_tree_close(jstate.ema_params[part], ema, 1e-5, atol, f"ema {part}")
    if variant.get("accum"):
        assert state.opt_state["count"] == 1 and state.opt_state["mini_step"] == 1


def test_bf16_compute_train_steps_close_to_jax():
    variant = VARIANTS["adamw"]
    jstate, jlosses, (_, unet_m, _), losses = _run_variant(
        variant, compute=jnp.bfloat16, tdtype=torch.bfloat16)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    p0 = params_from_jax(_jax_params()[0])
    want = params_from_jax(jax.tree.map(np.asarray, jstate.unet_params))
    got, ref = [], []
    for name, p in unet_m.state_dict().items():
        got.append((p.float() - p0[name]).flatten())
        ref.append((want[name] - p0[name]).flatten())
        rel = float((got[-1] - ref[-1]).norm() / ref[-1].norm().clamp_min(1e-12))
        assert rel < 0.2, (name, rel)
    got, ref = torch.cat(got), torch.cat(ref)
    assert float((got - ref).norm() / ref.norm()) < 0.1


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss", "nll_mean",
                                  "nll_sum", "q_sample"])
def test_losses_match_jax(name):
    """The losses module against the JAX package's on the same inputs,
    float32: rtol 1e-6."""
    from ldm_tf2_tpu.diffusion import losses as jl
    from ldm_tf2_tpu_torch.diffusion import losses as tl

    rng = np.random.default_rng(6)
    a, b, c = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(3))
    if name == "q_sample":
        acp, one_m = (rng.uniform(0.1, 1.0, 100).astype(np.float32) for _ in range(2))
        t = np.array([3, 71])
        args = (acp, one_m, a, t, b)
        want = jl.q_sample(*(jnp.asarray(x) for x in args))
        got = tl.q_sample(*(torch.as_tensor(x) for x in args))
    elif name.startswith("nll"):
        kw = dict(lpips_weight=0.7, reduce_loss=name == "nll_sum")
        want = jl.nll_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), **kw)
        got = tl.nll_loss(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c), **kw)
    else:
        want = jl.D_LOSS_MAP[name.split("_")[0]](jnp.asarray(a), jnp.asarray(b))
        got = tl.D_LOSS_MAP[name.split("_")[0]](torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_schedule_reads_the_count_before_the_increment():
    """optax's warm-up cosine at counts 0, 1, 2 (decay_steps counts the
    warm-up), and the warm-up joined to the constant rate."""
    import optax

    cos = tt.make_optimizer(learning_rate=1e-3, warmup_steps=2, decay_steps=6,
                            end_learning_rate_factor=0.1)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6, 1e-4)
    warm = tt.make_optimizer(learning_rate=1e-3, warmup_steps=3)
    ref_warm = optax.join_schedules([optax.linear_schedule(0.0, 1e-3, 3),
                                     optax.constant_schedule(1e-3)], [3])
    for count in range(9):
        np.testing.assert_allclose(cos.learning_rate(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(warm.learning_rate(count), float(ref_warm(count)),
                                   rtol=1e-6, atol=1e-12)
    assert cos.learning_rate(0) == 0.0
