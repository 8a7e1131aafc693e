"""The PyTorch port's operators against the JAX package's.

Inputs are drawn with numpy from a fixed seed and fed to both sides in
float32.  Where the JAX function reaches a Pallas kernel it runs as the JAX
package's own tests run it on the CPU: the flash kernel under
``force_tpu_interpret_mode`` and the FFN kernel through ``_pallas_ffn``
(which interprets off the TPU), plus their XLA references.  On the CPU the
port's kernel wrappers take their plain versions; the CUDA kernels are
held to those plain versions by ``test_torch_kernels_cuda.py`` (skipped
without a card) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldm_tf2_tpu.ops import flash_attention as jfa
from ldm_tf2_tpu.ops import fused_conv as jfc
from ldm_tf2_tpu.ops import fused_ffn as jff
from ldm_tf2_tpu.ops import group_norm as jgn
from ldm_tf2_tpu.ops.resize import nearest_upsample_2x as j_upsample
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention
from ldm_tf2_tpu_torch.ops.fused_conv import gn_silu_conv3x3
from ldm_tf2_tpu_torch.ops.group_norm import group_norm
from ldm_tf2_tpu_torch.ops.resize import nearest_upsample_2x


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "b,q_len,kv_len,h,s",
    [
        (1, 128, 128, 2, 40),   # U-Net level-0 head dim
        (1, 64, 64, 2, 80),     # level-1 head dim
        (1, 32, 32, 2, 160),    # level-2 / middle head dim
        (1, 64, 64, 1, 512),    # autoencoder mid-block: one 512-wide head
        (2, 96, 70, 2, 40),     # ragged q and kv lengths
    ],
)
def test_flash_attention_plain_matches_jax(b, q_len, kv_len, h, s):
    rng = np.random.default_rng(0)
    q = _randn(rng, b, q_len, h, s)
    k = _randn(rng, b, kv_len, h, s)
    v = _randn(rng, b, kv_len, h, s)
    scale = s**-0.5
    got = flash_attention(_t(q), _t(k), _t(v), scale).numpy()
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jfa.flash_attention(q, k, v, scale))
    ref = np.asarray(jfa._xla_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), scale))
    # f32 throughout; the two differ only in summation order (the JAX flash
    # test's own 2e-5 tolerance)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


def _ffn_args(rng, d):
    h4 = 4 * d
    return (
        _randn(rng, d, scale=0.1) + 1.0, _randn(rng, d, scale=0.1),
        _randn(rng, d, h4, scale=d**-0.5), _randn(rng, h4, scale=0.1),
        _randn(rng, d, h4, scale=d**-0.5), _randn(rng, h4, scale=0.1),
        _randn(rng, h4, d, scale=h4**-0.5), _randn(rng, d, scale=0.1),
    )


@pytest.mark.parametrize("b,t,d", [(1, 128, 64), (2, 128, 40)])
def test_plain_ffn_matches_jax(b, t, d):
    rng = np.random.default_rng(1)
    x = _randn(rng, b, t, d)
    params = _ffn_args(rng, d)
    got = tff.fused_ffn(_t(x), *map(_t, params)).numpy()
    ref = np.asarray(jff._xla_ffn(x, *params, 1e-5))
    # same math in f32, different summation order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    kernel = np.asarray(jff._pallas_ffn(x, *params, 1e-5))
    # the Pallas kernel's degree-9 polynomial GELU is within 2.3e-5 of the
    # exact erf GELU the port uses; through w2 that is about 1e-4
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_mxu_stats(activate, eps):
    rng = np.random.default_rng(2)
    x = _randn(rng, 2, 8, 8, 64, scale=3.0) + 1.5
    gamma, beta = _randn(rng, 64) + 1.0, _randn(rng, 64)
    got = group_norm(_t(x), _t(gamma), _t(beta), 32, eps, activate).numpy()
    ref = np.asarray(jgn._mxu_stats_group_norm(x, gamma, beta, 32, eps,
                                               activate))
    # f32 one-pass statistics on both sides
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_t,with_add", [(False, False), (True, False),
                                             (False, True)])
def test_gn_silu_conv_matches_xla_ref(with_t, with_add):
    rng = np.random.default_rng(3)
    cin, cout = 64, 32
    x = _randn(rng, 2, 8, 8, cin)
    gamma, beta = _randn(rng, cin) + 1.0, _randn(rng, cin)
    w = _randn(rng, 3, 3, cin, cout, scale=0.1)  # HWIO, as the JAX side
    bias = _randn(rng, cout)
    t = _randn(rng, 2, cout) if with_t else None
    add = _randn(rng, 2, 8, 8, cout) if with_add else None
    got = gn_silu_conv3x3(
        _t(x), _t(gamma), _t(beta), _t(w.transpose(3, 2, 0, 1)), _t(bias),
        time_add=None if t is None else _t(t),
        residual_add=None if add is None else _t(add), eps=1e-5,
    ).numpy()
    ref = np.asarray(jfc._xla_ref(x, gamma, beta, w, bias, t, add, 32, 1e-5))
    # conv summation order differs (oneDNN vs XLA)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_nearest_upsample_2x_matches_jax():
    x = _randn(np.random.default_rng(4), 2, 3, 5, 4)
    np.testing.assert_array_equal(
        nearest_upsample_2x(_t(x)).numpy(), np.asarray(j_upsample(x))
    )


def test_wrappers_check_inputs():
    q = torch.zeros(1, 8, 2, 40)
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q, 1.0)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 2, 48), q, 1.0)
    x = torch.zeros(1, 8, 64)
    params = [_t(p) for p in _ffn_args(np.random.default_rng(5), 64)]
    with pytest.raises(ValueError):
        tff.fused_ffn(x, *params[:6], params[6][:, :32], params[7])


def test_wrappers_take_no_fallback_off_cpu():
    """A tensor that is not on the CPU never gets the plain version: the
    wrapper launches its kernel or raises."""
    q = torch.zeros(1, 8, 2, 40, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q, 1.0)
    x = torch.zeros(1, 8, 64, device="meta")
    params = [_t(p).to("meta") for p in _ffn_args(np.random.default_rng(6), 64)]
    with pytest.raises(ValueError):
        tff.fused_ffn(x, *params)
