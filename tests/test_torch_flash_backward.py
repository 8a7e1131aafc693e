"""The port's differentiable kernels against the JAX package, on the CPU.

* Flash attention: the port's ``autograd.Function`` (plain forward with
  its ``lse``, plain FA-2 backward: the CPU forms of the forward kernel and
  of the dq and dk/dv kernels) against ``jax.vjp`` of
  ``ldm_tf2_tpu.ops.flash_attention.flash_attention``, whose backward runs
  ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode.  float32: only the
  summation order differs, rtol 1e-4 / atol 1e-5 on dq, dk, dv.  bf16: the
  two forwards round at different places (the port's plain version rounds
  p to bf16 before P.V as the JAX package's XLA reference does, the TPU
  kernel does not), so each gradient within 2e-2 rel-L2.
* The fused FFN's gradients against ``jax.vjp`` of ``_xla_ffn`` (float32,
  rtol 1e-4 / atol 1e-5).
* The int8 serving kernels refuse to be differentiated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldm_tf2_tpu.ops import flash_attention as jfa
from ldm_tf2_tpu.ops.fused_ffn import _xla_ffn
from ldm_tf2_tpu_torch.ops import flash_attention as tfa
from ldm_tf2_tpu_torch.ops import quant_conv as tqc
from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_grads(q, k, v, dout, scale, dtype):
    args = [jnp.asarray(a, _JNP[dtype]) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale), *args)
        grads = vjp(jnp.asarray(dout, _JNP[dtype]))
    return [np.asarray(g.astype(jnp.float32)) for g in (out, *grads)]


def _port_grads(q, k, v, dout, scale, dtype):
    args = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*args, scale)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    grads = torch.autograd.grad(out, args, torch.tensor(dout).to(dtype))
    return [t.detach().float().numpy() for t in (out, *grads)]


def _inputs(b, tq, tk, h, s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, tq, h, s), (b, tk, h, s), (b, tk, h, s), (b, tq, h, s))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,s", [(1, 64, 64, 2, 40), (1, 64, 64, 2, 80),
                                         (2, 16, 16, 2, 160), (1, 128, 100, 2, 40)])
def test_flash_backward_matches_jax_kernels(dtype, b, tq, tk, h, s):
    """The U-Net's head dims and a ragged kv of 100 (the TPU kernels pad it
    to 128 and mask the tail)."""
    q, k, v, dout = _inputs(b, tq, tk, h, s, seed=s + tk)
    scale = s**-0.5
    want = _jax_grads(q, k, v, dout, scale, dtype)
    got = _port_grads(q, k, v, dout, scale, dtype)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel < 2e-2, (name, rel)


def test_flash_backward_extreme_logits_ragged_kv():
    """The JAX package's case: logits near -141 over a kv of 100 padded to
    128.  Unmasked, exp(0 - lse) of a padded key overflows and 0 * inf
    poisons real rows; the port has no padding on the CPU, and its card
    kernels mask the same way (tests/test_torch_kernels_cuda.py)."""
    b, t, kv, h, s = 1, 128, 100, 1, 32
    q = np.full((b, t, h, s), 5.0, np.float32)
    k = np.full((b, kv, h, s), -5.0, np.float32)
    v = np.ones((b, kv, h, s), np.float32)
    dout = np.ones((b, t, h, s), np.float32)
    want = _jax_grads(q, k, v, dout, s**-0.5, torch.float32)
    got = _port_grads(q, k, v, dout, s**-0.5, torch.float32)
    # dq is 0 here (all keys are equal): a sum of terms of about 30 that
    # cancel, so both sides hold rounding noise of 1e-5 (2e-5 measured)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.filterwarnings("ignore:Input #")
def test_flash_function_passes_gradcheck_in_float32():
    """The Function's gradients against central differences, in float32
    (the kernels' dtypes): eps 1e-3 with atol 1e-3 / rtol 1e-2 holds the
    differences' own error (about 1e-4 here); a wrong term is off by O(1)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, 2, 4, generator=g, requires_grad=True)
               for n in (3, 5, 5))
    assert torch.autograd.gradcheck(lambda a, b, c: tfa.flash_attention(a, b, c, 0.5),
                                    (q, k, v), eps=1e-3, atol=1e-3, rtol=1e-2)


def test_flash_backward_plain_kernels_split_as_the_tpu_pair():
    """``flash_attention_backward`` (di, then the dq and dk/dv plain
    versions from ``lse``) in float32 equals autograd through softmax
    attention in float64 to atol 2e-6 (4.3e-7 measured, gradients up to
    2.4); ``lse`` is the row log-sum-exp of the scaled logits (atol 1e-6)."""
    q, k, v, dout = (torch.tensor(a) for a in _inputs(2, 24, 19, 3, 8, seed=1))
    out, lse = tfa._plain_forward(q, k, v, 0.3)
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, 0.3)
    args = [t.double().requires_grad_(True) for t in (q, k, v)]
    logits = torch.einsum("bqhs,bchs->bhqc", args[0], args[1]) * 0.3
    ref_out = torch.einsum("bhqc,bchs->bqhs", torch.softmax(logits, dim=-1), args[2])
    want = torch.autograd.grad(ref_out, args, dout.double())
    for x, y in zip(got, want):
        torch.testing.assert_close(x.double(), y, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(lse.double(), torch.logsumexp(logits, dim=-1).detach(),
                               rtol=0, atol=1e-6)


def test_no_grad_flash_takes_the_plain_path():
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 8, 8, 2, 8, seed=2))
    out = tfa.flash_attention(q, k, v, 0.3)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tfa._plain(q, k, v, 0.3), rtol=0, atol=0)


def test_ffn_gradients_match_jax_vjp():
    rng = np.random.default_rng(5)
    d, f = 64, 256
    args = [rng.standard_normal((2, 16, d)),
            1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((d, f)) / 8, 0.1 * rng.standard_normal(f),
            rng.standard_normal((d, f)) / 8, 0.1 * rng.standard_normal(f),
            rng.standard_normal((f, d)) / 16, 0.1 * rng.standard_normal(d)]
    args = [a.astype(np.float32) for a in args]
    cot = rng.standard_normal((2, 16, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: _xla_ffn(*a, 1e-5), *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got_out = fused_ffn(*targs)
    assert type(got_out.grad_fn).__name__ == "_FusedFFNBackward"
    got = torch.autograd.grad(got_out, targs, torch.tensor(cot))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=f"argument {i}")


def test_int8_kernels_refuse_grad():
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="sampling-only"):
        tfa.flash_attention_pv_int8(q, q, q, 0.3)
    with torch.no_grad():
        tfa.flash_attention_pv_int8(q, q, q, 0.3)
    x = torch.randn(1, 4, 4, 32)
    gamma = torch.ones(32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="tpu.quantize: int8"):
        tqc.gn_silu_quant(x, gamma, torch.zeros(32))
    y8, sa = tqc.gn_silu_quant(x, gamma.detach(), torch.zeros(32))
    w8, ws = tqc.int8_conv_weights(torch.randn(32, 32, 3, 3))
    bias = torch.zeros(32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="sampling-only"):
        tqc.s8_conv3x3(y8, sa, w8, ws, bias)
    with torch.inference_mode():
        tqc.s8_conv3x3(y8, sa, w8, ws, bias)
