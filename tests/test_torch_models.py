"""The PyTorch port's models against the JAX package's, on the goldens.

Each JAX module is built at the size of ``tests/test_golden_parity.py``,
its weights drawn by ``golden_utils.materialize``; the same numpy tree goes
through the port's bridge.  The port is held to the reference goldens at
the JAX tests' CPU tolerances and to the JAX module's own output on the
same inputs (both in float32; only summation order differs).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _variables(init, order, seed=gu.SEED):
    """Materialized weights without running the random init."""
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


def test_transformer_matches_golden_and_jax():
    g = _golden("transformer")
    kwargs = dict(vocab_size=100, encoder_stack_size=2, hidden_size=64,
                  num_heads=2, size_per_head=16, max_seq_len=8,
                  filter_size=128, dropout_rate=0.0)
    ids = jnp.asarray(g["ids"], jnp.int32)
    jax_model = jm.TransformerModel(**kwargs)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), ids),
                           gu.transformer_order(2))
    expected = np.asarray(jax.jit(jax_model.apply)(variables, ids))
    model = load_params(tm.TransformerModel(**kwargs), variables)
    with torch.no_grad():
        out = model(torch.as_tensor(g["ids"])).numpy()
    np.testing.assert_allclose(out, g["out"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_unet_matches_golden_and_jax():
    g = _golden("unet")
    kwargs = dict(model_channels=160, out_channels=4, num_blocks=1,
                  channel_mult=(1, 2), num_heads=4, context_channels=1280,
                  dropout_rate=0.0)
    x, t, ctx = (g[k] for k in ("x", "t", "ctx"))
    jax_model = jm.UNet(**kwargs)
    variables = _variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), x, t, ctx),
        gu.unet_order(num_blocks=1, channel_mult=(1, 2)),
    )
    expected = np.asarray(jax.jit(jax_model.apply)(variables, x, t, ctx))
    model = load_params(tm.UNet(**kwargs), variables)
    with torch.no_grad():
        out = model(*(torch.as_tensor(a) for a in (x, t, ctx))).numpy()
    np.testing.assert_allclose(out, g["out"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-5)


def test_autoencoder_kl_matches_golden_and_jax():
    g = _golden("autoencoder_kl")
    kwargs = dict(channels=32, num_blocks=1, multipliers=(1, 2))
    x = g["x"]
    jax_model = jm.AutoencoderKL(**kwargs)
    key = jax.random.PRNGKey(0)
    variables = _variables(
        lambda: jax_model.init({"params": key, "sample": key}, x),
        gu.autoencoder_kl_order(1, (1, 2), image_size=16),
    )

    @jax.jit
    def jax_forward(variables, x):
        post = jax_model.apply(variables, x, method=jm.AutoencoderKL.encode)
        recon = jax_model.apply(variables, post.mode(),
                                method=jm.AutoencoderKL.decode)
        return post.mean, post.logvar, recon

    expected = [np.asarray(a) for a in jax_forward(variables, x)]
    model = load_params(tm.AutoencoderKL(**kwargs), variables)
    with torch.no_grad():
        post = model.encode(torch.as_tensor(x))
        recon = model.decode(post.mode())
    got = [post.mean.numpy(), post.logvar.numpy(), recon.numpy()]
    for name, out, want, ref in zip(("mean", "logvar", "recon"), got,
                                    (g["mean"], g["logvar"], g["recon"]),
                                    expected):
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_diagonal_gaussian_sample_uses_generator():
    mean = torch.zeros(2, 4, 4, 4)
    logvar = torch.full((2, 4, 4, 4), 100.0)  # clipped to 20
    post = tm.DiagonalGaussian.create(mean, logvar)
    assert float(post.logvar.max()) == 20.0
    a = post.sample(torch.Generator().manual_seed(3))
    b = post.sample(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, mean + np.exp(10.0) * noise)
    assert post.mode() is mean


def test_unet_runs_in_compute_dtype():
    """The bf16 compute dtype flows through the whole U-Net (f32 params,
    bf16 activations), as ``tpu.compute_dtype`` asks."""
    dtype = torch.bfloat16
    model = tm.UNet(model_channels=64, num_blocks=1, channel_mult=(1, 2),
                    num_heads=2, context_channels=32, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        out = model(torch.randn(2, 8, 8, 4, generator=gen),
                    torch.tensor([1.0, 500.0]),
                    torch.randn(2, 5, 32, generator=gen))
    assert out.dtype == dtype and out.shape == (2, 8, 8, 4)
    assert bool(torch.isfinite(out.float()).all())
