"""The port's W8A8 FFN (the TPU kernel ``_ffn_kernel_int8``) against the JAX
package's, on the CPU.

``_pallas_ffn_int8`` runs in interpret mode, as the JAX package's own
tests run it; the port's plain version ``_plain_ffn_int8`` is what its
wrapper takes on CPU tensors.  Both quantize the same weights per column
(``quantize_cols``, bit for bit equal to ``_quant_cols``); the LayerNorm's
summation order (and XLA's rsqrt) differs, which flips a code where a
value lies within an ulp of a rounding midpoint, and one flipped code of
y or u moves its whole output row by about 1e-2.  Measured on these
inputs (float32): rows without a flip agree to 2e-6 absolute (rel-L2
1.2e-7 where no row flips); 0 to 4 rows of 256-512 flip, which takes the
whole tensor's rel-L2 to at most 3.1e-4; bf16 at most 3.6e-4.  Bounds:
float32 rel-L2 1e-3 with at least 98% of rows within 1e-4 absolute, bf16
rel-L2 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.ops import fused_ffn as jff
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops import quant_conv as tqc

TOL = {"float32": 1e-3, "bfloat16": 5e-3}


def _inputs(b, t, d, seed=0):
    rng = np.random.default_rng(seed)
    f = 4 * d
    return dict(
        x=rng.standard_normal((b, t, d)).astype(np.float32),
        lns=(rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        lnb=(rng.standard_normal(d) * 0.1).astype(np.float32),
        w1v=(rng.standard_normal((d, f)) * d**-0.5).astype(np.float32),
        b1v=np.linspace(-0.1, 0.1, f, dtype=np.float32),
        w1g=(rng.standard_normal((d, f)) * d**-0.5).astype(np.float32),
        b1g=np.linspace(0.1, -0.1, f, dtype=np.float32),
        w2=(rng.standard_normal((f, d)) * f**-0.5).astype(np.float32),
        b2=np.linspace(-0.1, 0.1, d, dtype=np.float32),
    )


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _both(inp, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    act = ("x", "w1v", "b1v", "w1g", "b1g", "w2", "b2")
    jargs = {k: jnp.asarray(v, jdt if k in act else jnp.float32) for k, v in inp.items()}
    want = jff._pallas_ffn_int8(jargs["x"], jargs["lns"], jargs["lnb"], jargs["w1v"],
                                jargs["b1v"], jargs["w1g"], jargs["b1g"], jargs["w2"],
                                jargs["b2"], 1e-5)
    targs = {k: torch.as_tensor(v).to(tdt if k in act else torch.float32)
             for k, v in inp.items()}
    q = tff.quantize_ffn_weights(targs["w1v"], targs["w1g"], targs["w2"])
    got = tff.fused_ffn_int8(targs["x"], targs["lns"], targs["lnb"], q, targs["b1v"],
                             targs["b1g"], targs["b2"])
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d", [(2, 256, 320), (1, 512, 128), (1, 256, 640)])
def test_plain_int8_ffn_matches_jax_interpret(b, t, d, dtype):
    got, want = _both(_inputs(b, t, d), dtype)
    assert got.shape == (b, t, d)
    assert _rel_l2(got, want) <= TOL[dtype]
    if dtype == "float32":  # most rows have no code flip and agree closely
        row_err = np.abs(got - want).reshape(b * t, d).max(axis=-1)
        assert np.mean(row_err <= 1e-4) >= 0.98


def test_plain_int8_ffn_takes_any_row_count():
    """The result does not depend on the M tile: 200 rows (not a multiple of
    128, which the JAX wrapper asserts) give the rows of the 256-row call."""
    inp = _inputs(1, 256, 128, seed=3)
    q = tff.quantize_ffn_weights(*(torch.as_tensor(inp[k]) for k in ("w1v", "w1g", "w2")))
    args = [torch.as_tensor(inp[k]) for k in ("lns", "lnb")]
    biases = [torch.as_tensor(inp[k]) for k in ("b1v", "b1g", "b2")]
    x = torch.as_tensor(inp["x"])
    full = tff.fused_ffn_int8(x, *args, q, *biases)
    part = tff.fused_ffn_int8(x[:, :200].contiguous(), *args, q, *biases)
    torch.testing.assert_close(part, full[:, :200], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cols_bit_for_bit(dtype):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 160)) * 0.3).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero column takes the 1e-12 floor
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j8, js = jff._quant_cols(jnp.asarray(w, jdt))
    t8, ts = tqc.quantize_cols(torch.as_tensor(w).to(tdt))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(-1))


def test_gelu_poly_matches_jax():
    x = np.linspace(-6.0, 6.0, 4801, dtype=np.float32)
    want = np.asarray(jff._gelu_poly_f32(jnp.asarray(x)))
    got = tff.gelu_poly(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    exact = torch.nn.functional.gelu(torch.as_tensor(x).double()).numpy()
    assert np.abs(got - exact).max() < 1.5e-4  # the fit's own bound at the clamp


def test_int8_ffn_not_dispatched(monkeypatch):
    """Mirror of the JAX ``test_int8_ffn_not_dispatched``: with the int8
    serving modes on, the U-Net's FFNs still take ``fused_ffn``'s bf16
    route, and the int8 FFN is never called."""
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.models import UNet

    def refuse(*args, **kwargs):
        raise AssertionError("the int8 FFN was dispatched")

    monkeypatch.setattr(tff, "fused_ffn_int8", refuse)
    monkeypatch.setattr(tff, "_plain_ffn_int8", refuse)
    unet = UNet(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
                num_heads=2, context_channels=64, dropout_rate=0.0)
    factory.randomize_(unet, seed=0)
    gen = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 16, 16, 4, generator=gen), torch.randn(2, 5, 64, generator=gen)
    t = torch.tensor([981.0, 21.0])
    ffn_inputs = []
    real_ffn = tff.fused_ffn

    def spy(*args, **kwargs):
        ffn_inputs.append((args, kwargs))
        return real_ffn(*args, **kwargs)

    import ldm_tf2_tpu_torch.models.unet as unet_mod

    monkeypatch.setattr(unet_mod, "fused_ffn", spy)
    unet.set_serving_modes(conv_quant=True, attention_pv_int8=True)
    with torch.no_grad():
        unet(x, t, ctx)
    assert ffn_inputs  # every FFN went through fused_ffn ...
    for args, kwargs in ffn_inputs:  # ... which computed the bf16 route's function
        torch.testing.assert_close(real_ffn(*args, **kwargs), tff._plain_ffn(*args, **kwargs),
                                   rtol=0, atol=0)


def test_int8_ffn_refuses_grad_and_takes_no_fallback():
    inp = _inputs(1, 64, 64, seed=1)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    q = tff.quantize_ffn_weights(t["w1v"], t["w1g"], t["w2"])
    x = t["x"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="differentiation"):
        tff.fused_ffn_int8(x, t["lns"], t["lnb"], q, t["b1v"], t["b1g"], t["b2"])
    with torch.no_grad():  # no grad recorded: it runs
        tff.fused_ffn_int8(x, t["lns"], t["lnb"], q, t["b1v"], t["b1g"], t["b2"])
    meta = {k: v.detach().to("meta") for k, v in t.items()}
    qm = tff.Int8FFNWeights(*(w.to("meta") for w in q))
    with pytest.raises(ValueError):  # not a CPU tensor: the kernel or an error
        tff.fused_ffn_int8(meta["x"], meta["lns"], meta["lnb"], qm, meta["b1v"],
                           meta["b1g"], meta["b2"])
    with pytest.raises(ValueError):  # a misshapen weight
        tff.fused_ffn_int8(x.detach(), t["lns"], t["lnb"], q._replace(w28=q.w1v8),
                           t["b1v"], t["b1g"], t["b2"])
