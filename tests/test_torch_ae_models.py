"""The stage-1 models of the port against the JAX package's, on the goldens.

Each JAX module is built at the size of ``tests/test_golden_parity.py``,
its weights drawn by ``golden_utils.materialize``; the same numpy tree
(``batch_stats`` included) goes through the port's bridge.  The port is
held to the goldens at the JAX tests' tolerances and to the flax module's
own output on the same inputs at 1e-5 in float32 (only summation order
differs).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.models.distribution import DiagonalGaussian as JaxGaussian
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.models.layers import dropout

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _variables(init, order, seed=gu.SEED):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


def _vq_case(prod=False):
    if prod:
        kwargs = dict(channels=128, num_blocks=2, multipliers=(1, 2, 2, 4),
                      attention_resolutions=(32,), vocab_size=16384)
        order, seed, size = gu.autoencoder_vq_order(2, (1, 2, 2, 4), 256, (32,)), gu.SEED + 18, 256
        g = _golden("autoencoder_vq_prod")
    else:
        kwargs = dict(channels=32, num_blocks=1, multipliers=(1, 2),
                      attention_resolutions=(8,), vocab_size=32)
        order, seed, size = gu.autoencoder_vq_order(1, (1, 2), 16, (8,)), gu.SEED, 16
        g = _golden("autoencoder_vq")
    jax_model = jm.AutoencoderVQ(**kwargs)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), g["x"]),
                           order, seed)
    model = load_params(tm.AutoencoderVQ(**kwargs, resolution=size), variables)
    return g, jax_model, variables, model


def _check_vq(prod):
    g, jax_model, variables, model = _vq_case(prod)
    rtol, atol, loss_atol = (1e-3, 1e-4, 1e-5) if prod else (1e-4, 1e-5, 1e-6)
    x = torch.as_tensor(g["x"])
    with torch.no_grad():
        latents = model.encode(x, only_encode=True)
        quantized, loss, indices = model.encode(x)
        recon = model.decode(torch.as_tensor(g["quantized"]))
        forced = model.decode(latents, force_quantize=True)
    np.testing.assert_array_equal(indices.numpy(), g["indices"])
    np.testing.assert_allclose(latents.numpy(), g["latents"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(quantized.numpy(), g["quantized"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(loss), float(g["codebook_loss"]), rtol=rtol,
                               atol=loss_atol)
    np.testing.assert_allclose(recon.numpy(), g["recon"], rtol=rtol,
                               atol=1e-3 if prod else 1e-5)
    # force_quantize decodes the quantized latents
    torch.testing.assert_close(forced, model.decode(quantized.detach()))
    return g, jax_model, variables, (latents, quantized, loss, indices, recon)


def test_autoencoder_vq_matches_golden_and_jax():
    g, jax_model, variables, got = _check_vq(prod=False)
    latents, quantized, loss, indices, recon = got

    @jax.jit
    def jax_forward(variables, x, q):
        z = jax_model.apply(variables, x, only_encode=True,
                            method=jm.AutoencoderVQ.encode)
        qz, cl, idx = jax_model.apply(variables, x, method=jm.AutoencoderVQ.encode)
        r = jax_model.apply(variables, q, method=jm.AutoencoderVQ.decode)
        f = jax_model.apply(variables, z, force_quantize=True,
                            method=jm.AutoencoderVQ.decode)
        return z, qz, cl, idx, r, f

    z, qz, cl, idx, r, f = (np.asarray(a) for a in jax_forward(variables, g["x"], g["quantized"]))
    np.testing.assert_array_equal(indices.numpy(), idx)
    for name, a, b in (("latents", latents, z), ("quantized", quantized, qz),
                       ("recon", recon, r)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(loss), float(cl), rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        forced = _vq_case()[3].decode(latents, force_quantize=True)
    np.testing.assert_allclose(forced.numpy(), f, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_autoencoder_vq_production_shape_matches_golden():
    _check_vq(prod=True)


def test_vector_quantizer_gradients_match_jax():
    """The straight-through estimator and the codebook loss's beta
    placement, held to ``jax.grad`` of the JAX quantizer."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    codebook = rng.standard_normal((16, 4)).astype(np.float32)
    cot = rng.standard_normal(z.shape).astype(np.float32)
    jq = jm.VectorQuantizer(vocab_size=16, hidden_size=4, beta=0.25)

    def jax_loss(params, z):
        q, loss, _ = jq.apply({"params": params}, z)
        return jnp.sum(q * cot) + 3.0 * loss

    jg_params, jg_z = jax.grad(jax_loss, argnums=(0, 1))({"kernel": codebook}, z)
    quantizer = tm.VectorQuantizer(16, 4, 0.25)
    with torch.no_grad():
        quantizer.kernel.copy_(torch.as_tensor(codebook))
    zt = torch.as_tensor(z).requires_grad_(True)
    q, loss, _ = quantizer(zt)
    (q * torch.as_tensor(cot)).sum().add(3.0 * loss).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg_z), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(quantizer.kernel.grad.numpy(),
                               np.asarray(jg_params["kernel"]), rtol=1e-5, atol=1e-6)


def test_vector_quantizer_takes_first_index_on_ties():
    quantizer = tm.VectorQuantizer(4, 2, 0.25)
    with torch.no_grad():
        quantizer.kernel.copy_(torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0],
                                             [-1.0, 0.0]]))
    # equidistant from codes 0, 1 and 2
    _, _, idx = quantizer(torch.tensor([[[[0.5, 0.5]]]]))
    assert idx.tolist() == [0]


def _disc_case():
    g = _golden("discriminator")
    jax_model = jm.Discriminator(channels=16, num_layers=2)
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), g["x"]),
                           gu.discriminator_order(2))
    model = load_params(tm.Discriminator(16, 2), variables)
    return g, jax_model, variables, model


def test_discriminator_matches_golden_and_jax():
    g, jax_model, variables, model = _disc_case()
    expected = np.asarray(jax.jit(jax_model.apply)(variables, g["x"]))
    with torch.no_grad():
        out = model(torch.as_tensor(g["x"])).numpy()
    np.testing.assert_allclose(out, g["out"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_discriminator_training_mode_and_running_stats_match_flax():
    """Two training-mode calls in a row (real, then fake) against flax's
    ``mutable=["batch_stats"]``: outputs, then the running statistics after
    each call (flax's biased fast variance, momentum on the old value)."""
    g, jax_model, variables, model = _disc_case()
    rng = np.random.default_rng(1)
    xs = [g["x"], (rng.standard_normal(g["x"].shape) * 0.7 + 0.3).astype(np.float32)]

    @jax.jit
    def train_apply(variables, x):
        return jax_model.apply(variables, x, training=True, mutable=["batch_stats"])

    for x in xs:
        out, new = train_apply(variables, x)
        variables = {"params": variables["params"], "batch_stats": new["batch_stats"]}
        with torch.no_grad():
            got = model(torch.as_tensor(x), training=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
        for name, stats in variables["batch_stats"].items():
            bn = getattr(model, name)
            np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name}.mean")
            np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name}.var")
    # and the eval mode reads the updated running statistics
    expected = np.asarray(jax_model.apply(variables, xs[0]))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.as_tensor(xs[0])).numpy(), expected,
                                   rtol=1e-5, atol=1e-5)


def test_batchnorm_variance_is_fast_clamped_and_biased():
    """A channel whose float32 fast variance is -16 (two values near 2^13.6,
    where E[x^2] rounds below mean^2; two values sum in any order alike)
    is clamped to 0, and the running variance takes the biased batch
    variance."""
    bn = tm.discriminator.BatchNorm(2)
    with torch.no_grad():
        bn.scale.fill_(1.0)
        bn.bias.zero_()
    x = torch.tensor([[[[12345.0, 1.0]]], [[[12346.0, 3.0]]]])  # [2, 1, 1, 2]
    xf = x.double()
    fast = float((x * x).mean(dim=(0, 1, 2))[0] - x.mean(dim=(0, 1, 2))[0] ** 2)
    assert fast == -16.0  # float32 cancellation; the exact variance is 0.25
    with torch.no_grad():
        bn(x, training=True)
    assert float(bn.var[0]) == pytest.approx(0.9)  # 0.9 * 1 + 0.1 * 0
    biased = float(xf[..., 1].var(unbiased=False))
    assert float(bn.var[1]) == pytest.approx(0.9 + 0.1 * biased)
    assert float(bn.mean[1]) == pytest.approx(0.1 * 2.0)


def test_lpips_matches_golden_and_jax():
    g = _golden("lpips")
    jax_model = jm.LPIPS()
    variables = _variables(lambda: jax_model.init(jax.random.PRNGKey(0), g["a"], g["b"]),
                           gu.lpips_order())
    expected = np.asarray(jax.jit(jax_model.apply)(variables, g["a"], g["b"]))
    model = load_params(tm.LPIPS(), variables).requires_grad_(False)
    a, b = torch.as_tensor(g["a"]), torch.as_tensor(g["b"]).requires_grad_(True)
    out = model(a, b)
    np.testing.assert_allclose(out.detach().numpy(), g["out"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5, atol=1e-6)
    assert out.shape == (a.shape[0], 1, 1, 1)
    # frozen, but gradients flow through it to the images
    out.sum().backward()
    assert b.grad is not None and float(b.grad.abs().sum()) > 0.0
    assert all(p.grad is None for p in model.parameters())


def test_kl_matches_jax():
    rng = np.random.default_rng(2)
    mean = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    logvar = (rng.standard_normal((3, 4, 4, 4)) * 3.0).astype(np.float32)
    logvar[0, 0, 0, 0] = 40.0  # clipped to 20 on both sides
    want = np.asarray(JaxGaussian.create(jnp.asarray(mean), jnp.asarray(logvar)).kl())
    got = tm.DiagonalGaussian.create(torch.as_tensor(mean), torch.as_tensor(logvar)).kl()
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_dropout_statistics_and_mask_parity():
    """flax ``nn.Dropout``'s function at rate 0.3: kept elements scaled by
    1 / 0.7, a keep share near 0.7; the same mask given to both sides gives
    the same output."""
    x = torch.full((64, 64, 32), 2.0)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)  # drawn from the generator alone
    assert torch.equal(dropout(x, 0.3, None), x)  # not training
    # the JAX Dropout with the port's mask as its rng-free counterpart
    mask = kept.numpy()
    jax_y = np.asarray(jnp.where(mask, jnp.asarray(x.numpy()) / 0.7, 0.0))
    np.testing.assert_allclose(y.numpy(), jax_y, rtol=1e-6)


def test_autoencoder_training_mode_dropout():
    """Dropout > 0 in training mode: the split ResidualBlock path runs
    (GN+SiLU -> dropout -> conv), draws come from the generator alone, and
    with a rate whose masks keep every element it computes the eval path's
    function; the rate 0 of the configs keeps the fused chain."""
    kwargs = dict(channels=32, num_blocks=1, multipliers=(1, 2),
                  attention_resolutions=(8,), vocab_size=32, resolution=16)
    torch.manual_seed(0)
    model = tm.AutoencoderVQ(**kwargs, dropout_rate=0.5)
    from ldm_tf2_tpu_torch import factory

    factory.randomize_(model, seed=3)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        eval_z = model.encode(x, only_encode=True)
        a = model.encode(x, only_encode=True, generator=torch.Generator().manual_seed(1))
        b = model.encode(x, only_encode=True, generator=torch.Generator().manual_seed(1))
        c = model.encode(x, only_encode=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, eval_z)
    keep_all = tm.AutoencoderVQ(**kwargs, dropout_rate=1e-9)
    keep_all.load_state_dict(model.state_dict())
    with torch.no_grad():
        d = keep_all.encode(x, only_encode=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(d, eval_z, rtol=1e-5, atol=1e-5)


def test_attention_placed_by_resolution():
    """VQ attention fires where the spatial size is in
    ``attention_resolutions``; a map that asks for it where the model was
    built without it raises."""
    model = tm.AutoencoderVQ(channels=32, num_blocks=1, multipliers=(1, 2),
                             attention_resolutions=(8,), vocab_size=32, resolution=16)
    names = [n for n, m in model.named_modules() if isinstance(m, tm.autoencoder.AttentionBlock)]
    assert names == ["encoder.down_2.attention", "encoder.middle.attention",
                     "decoder.middle.attention", "decoder.up_0.attention",
                     "decoder.up_1.attention"]
    from ldm_tf2_tpu_torch import factory

    factory.randomize_(model, seed=0)
    with pytest.raises(ValueError, match="built without it"):
        model.encode(torch.zeros(1, 8, 8, 3), only_encode=True)


def test_autoencoder_kl_without_resample_conv_matches_jax():
    """``resample_with_conv: false`` (a 2x2 average pool down, nearest up
    without a conv) and an ``attention_resolutions`` the KL model ignores,
    against the flax module on the same weights."""
    kwargs = dict(channels=32, num_blocks=1, multipliers=(1, 2), attention_resolutions=(8,),
                  resample_with_conv=False)
    jax_model = jm.AutoencoderKL(**kwargs)
    x = np.random.default_rng(6).standard_normal((1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_model.init({"params": key, "sample": key}, x))
    rng = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)

    @jax.jit
    def jax_forward(variables, x):
        post = jax_model.apply(variables, x, method=jm.AutoencoderKL.encode)
        return post.mean, jax_model.apply(variables, post.mode(),
                                          method=jm.AutoencoderKL.decode)

    mean, recon = (np.asarray(a) for a in jax_forward(variables, x))
    model = load_params(tm.AutoencoderKL(**kwargs), variables)
    with torch.no_grad():
        post = model.encode(torch.as_tensor(x))
        got = model.decode(post.mode())
    np.testing.assert_allclose(post.mean.numpy(), mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), recon, rtol=1e-5, atol=1e-5)
