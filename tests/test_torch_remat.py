"""Remat of the port's LDM train step (``tpu.remat``; ``models/remat.py``)
on the CPU.

* Each policy (True, "full", "blocks", "dots") takes the step the plain
  step takes, with dropout on at 0.1 so that elements drop and a recompute
  that drew new masks would give another gradient: loss and every updated
  parameter bit-equal.
* The step generator ends in the same state with and without remat, after
  the forward and after the backward, so the draws after the U-Net do not
  move.
* "blocks" against the JAX ``make_ldm_train_step(..., remat_unet="blocks")``
  at dropout 0 with injected draws, at ``tests/test_trainers.py``'s remat
  tolerances (loss rtol 1e-5, parameters atol 1e-5); one JAX step is
  compiled.
* The bytes autograd saves outside the checkpoint segments order as full <
  blocks < none (``saved_tensors_hooks``), so the policies differ.
* The autoencoder trainer ignores ``tpu.remat``, as the JAX one does.
"""

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
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.models import remat
from ldm_tf2_tpu_torch.training import ldm_trainer as tt
from test_torch_train import (
    AE, COND, IMG, NULL_IDS, SEED, UNET, _assert_tree_close, _batch, _jax_draws,
    _jax_params, _port_models,
)

POLICIES = (True, "full", "blocks", "dots")
RATE = 0.1
_OPT = dict(learning_rate=1e-3, epsilon=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step(policy, rate=RATE, draws=None, steps=1):
    """``steps`` port train steps from the shared tiny weights; returns the
    losses and the U-Net's parameters."""
    cond, unet, ae = _port_models(rate=rate)
    unet.requires_grad_(True)
    opt = tt.make_optimizer(**_OPT)
    step = tt.make_ldm_train_step(
        unet, cond, ae, make_schedule(num_steps=100, num_ddim_steps=10), opt,
        condition_dropout_rate=0.1, null_token_ids=NULL_IDS, remat_unet=policy,
        ema_decay=0.9, seed=SEED)
    state = tt.init_ldm_train_state(unet, cond, opt, ema_decay=0.9)
    images, ids = _batch()
    losses = []
    for s in range(steps):
        state, m = step(state, torch.as_tensor(images), torch.as_tensor(ids).long(),
                        None if draws is None else draws(s))
        losses.append(float(m["loss"]))
    return losses, dict(unet.named_parameters()), state


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_step_equals_plain_step_with_dropout_on(policy):
    want_loss, want, want_state = _step(False, steps=2)
    got_loss, got, got_state = _step(policy, steps=2)
    assert got_loss == want_loss, (policy, got_loss, want_loss)
    for name, p in want.items():
        torch.testing.assert_close(got[name], p, rtol=0, atol=1e-6, msg=name)
    for name, e in want_state.ema.items():
        torch.testing.assert_close(got_state.ema[name], e, rtol=0, atol=1e-6, msg=name)
    # dropout did drop: at rate 0 the step is another one
    assert _step(False, rate=0.0)[0][0] != want_loss[0]


def _unet_and_inputs():
    _, unet, _ = _port_models(rate=RATE)
    unet.requires_grad_(True)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, IMG // 2, IMG // 2, 4)).astype(np.float32))
    t = torch.tensor([3.0, 70.0])
    ctx = torch.as_tensor(rng.standard_normal((2, 8, 32)).astype(np.float32))
    return unet, x, t, ctx


def _forward(unet, policy, g, x, t, ctx):
    if policy == "blocks":
        return unet(x, t, ctx, training=True, generator=g, remat_blocks=True)
    run = lambda g, x, t, c: unet(x, t, c, training=True, generator=g)
    if not policy:
        return run(g, x, t, ctx)
    return remat.checkpoint(run, g, x, t, ctx,
                            context_fn=remat.dots_context if policy == "dots" else None)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_step_generator_ends_where_the_plain_forward_leaves_it(policy):
    unet, x, t, ctx = _unet_and_inputs()
    ends = {}
    for p in (False, policy):
        g = torch.Generator().manual_seed(11)
        out = _forward(unet, p, g, x, t, ctx)
        after_forward = g.get_state()
        grads = torch.autograd.grad(out.square().mean(), list(unet.parameters()))
        assert torch.equal(g.get_state(), after_forward), p  # the recompute forks
        ends[p] = (out, grads, torch.rand(4, generator=g))
    (out0, g0, next0), (out1, g1, next1) = ends[False], ends[policy]
    assert torch.equal(out0, out1)
    assert torch.equal(next0, next1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _saved_bytes(policy) -> int:
    unet, x, t, ctx = _unet_and_inputs()
    total = [0]

    def pack(tensor):
        total[0] += tensor.numel() * tensor.element_size()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        out = _forward(unet, policy, torch.Generator().manual_seed(1), x, t, ctx)
    out.sum().backward()
    return total[0]


def test_saved_bytes_order_full_blocks_none():
    full, blocks, none = (_saved_bytes(p) for p in ("full", "blocks", False))
    assert full < blocks < none, (full, blocks, none)


def test_unknown_policy_raises():
    cond, unet, ae = _port_models()
    with pytest.raises(ValueError, match="remat"):
        tt.make_ldm_train_step(unet, cond, ae, make_schedule(num_steps=100),
                               tt.make_optimizer(), remat_unet="bogus")


def test_blocks_matches_jax_blocks_remat_step():
    up, cp, ap = _jax_params()
    unet = UNet(**UNET, dropout_rate=0.0)
    cond = TransformerModel(**COND, dropout_rate=0.0)
    ae = AutoencoderKL(**AE)

    def unet_apply(params, xt, t, ctx, rngs, training):
        return unet.apply({"params": params}, xt, t, ctx, training=training, rngs=rngs)

    def cond_apply(params, ids, rngs, training):
        return cond.apply({"params": params}, ids, training=training, rngs=rngs)

    def encode_latents(params, images, key):
        return ae.apply({"params": params}, images, method=AutoencoderKL.encode).sample(key)

    jopt = jax_make_optimizer(**_OPT)
    jstep = jax.jit(jax_make_step(
        unet_apply, cond_apply, encode_latents,
        jax_make_schedule(num_steps=100, num_ddim_steps=10), jopt,
        condition_dropout_rate=0.1, null_token_ids=jnp.asarray(NULL_IDS),
        remat_unet="blocks", ema_decay=0.9))
    images, ids = _batch()
    jstate = jax_init_state(up, cp, jopt, ema_decay=0.9)
    jstate, jm = jstep(jstate, ap, jnp.asarray(images), jnp.asarray(ids),
                       jax.random.PRNGKey(SEED))

    latent_shape = (2, IMG // 2, IMG // 2, 4)
    losses, params, _ = _step("blocks", rate=0.0, draws=lambda s: _jax_draws(
        s, 2, latent_shape, 1, jnp.float32))
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-5)
    _assert_tree_close(jstate.unet_params, params, 0, 1e-5, "unet")


def test_ae_trainer_ignores_remat(tmp_path):
    """A tiny VQ config trains the same steps to the same losses with
    ``tpu.remat: full`` as with false."""
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_autoencoder_trainer import train
    from ldm_tf2_tpu_torch.configs.loader import validate
    from test_torch_ae_train import _config

    rng = np.random.default_rng(2)
    batches = [rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2)]
    records = {}
    for policy in (False, "full"):
        config = _config(tmp_path, 2)
        config["autoencoder_training"]["ckpt_path"] = None
        config["tpu"]["remat"] = policy
        config = validate(config)
        models = (factory.init_params_(factory.build_autoencoder(
                      config, "vq", "cpu", None, resolution=16), 1),
                  factory.init_params_(factory.build_discriminator(config, "vq"), 2),
                  factory.randomize_(factory.build_lpips(config), 3))
        _, records[policy] = train(config, device="cpu", batches=batches, models=models)
    strip = lambda rs: [{k: v for k, v in r.items()
                         if k not in ("time", "steps_per_sec", "images_per_sec")}
                        for r in rs]
    assert strip(records["full"]) == strip(records[False])
    assert len(records[False]) == 2 and "d_loss" in records[False][1]
