"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the kernels have no CPU mode).  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ldm_tf2_tpu_torch.ops import flash_attention as tfa
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops import quant_conv as tqc
from ldm_tf2_tpu_torch.ops.attention import dot_product_attention
from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention


def _ffn_args(gen, d, dtype):
    f = 4 * d

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    ln = [randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)]
    ws = [randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
          randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
          randn(f, d, scale=f**-0.5), randn(d, scale=0.1)]
    return ln + [w.to(dtype) for w in ws]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s", [(2, 1024, 1024, 8, 40),
                                         (2, 256, 256, 8, 80),
                                         (2, 64, 64, 8, 160),
                                         (1, 1024, 1024, 1, 512),
                                         (2, 1000, 999, 8, 40),
                                         (2, 100, 77, 4, 36)])
def test_flash_kernel_matches_plain_on_card(dtype, b, t, kv, h, s):
    """bf16 S = 40, 80, 160 take the tensor-core path; S = 512 and S = 36
    (not a multiple of 8) the FMA path, as float32 does."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, h, s, generator=g, device="cuda").to(dtype)
               for n in (t, kv, kv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, s**-0.5).float()
    assert flash_attention.launches == before + 1
    ref = dot_product_attention(q.float(), k.float(), v.float(), s**-0.5)
    # f32: summation order only; bf16: one rounding of the output (2^-8)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((got - ref).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(4096, 320), (1024, 640), (256, 1280),
                                 (64, 1280), (100, 320),
                                 (100, 1280), (50, 384)])
def test_ffn_kernel_matches_plain_on_card(dtype, m, d):
    """bf16 d = 320, 640, 1280 take the tensor-core path; d = 384 the FMA
    path, as float32 does."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(1, m, d, generator=gen, device="cuda")
    cast = _ffn_args(gen, d, dtype)
    before = tff.fused_ffn.launches
    got = tff.fused_ffn(x.to(dtype), *cast).float()
    assert tff.fused_ffn.launches == before + 1
    ref = tff._plain_ffn(x.to(dtype).float(), *[p.float() for p in cast])
    # f32: summation order only; bf16: rounding of y, u and the output
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    assert float((got - ref).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 8, 8, 640), (2, 64, 64, 320)])
def test_gn_silu_quant_kernel_matches_plain_on_card(dtype, shape):
    """The serving path's 8x8 stage-1 shape and a large map (the TPU's
    streaming class): one kernel covers both."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device="cuda") * 0.5
    before = tqc.gn_silu_quant.launches
    y8, sa = tqc.gn_silu_quant(x, gamma, beta)
    assert tqc.gn_silu_quant.launches == before + 1
    r8, rsa = tqc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5)
    # float32 sums in another order: the scale to an ulp or two, the codes
    # to one step where a value lies within that of a rounding midpoint
    assert float(((sa - rsa).abs() / rsa).max()) <= 1e-6
    diff = (y8.int() - r8.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,epilogue", [((8, 32, 32, 320), 320, "t"),
                                                 ((8, 8, 8, 1280), 1280, "residual"),
                                                 ((3, 5, 7, 64), 40, "t")])
def test_s8_conv_kernel_matches_plain_on_card(dtype, shape, cout, epilogue):
    """The plain version is F.conv2d in float64 on the int8 values, which is
    exact, and the epilogue's float32 operations in the kernel's order: the
    outputs must be equal, bit for bit."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    b, h, w, cin = shape

    def codes(*s):
        return torch.randint(-127, 128, s, generator=g, device="cuda").to(torch.int8)

    y8, w8 = codes(b, h, w, cin), codes(cout, 3, 3, cin)
    sa = torch.rand(b, generator=g, device="cuda") * 0.1 + 0.01
    ws = torch.rand(cout, generator=g, device="cuda") * 0.01 + 1e-3
    bias = torch.randn(cout, generator=g, device="cuda")
    extra = {"time_add": torch.randn(b, cout, generator=g, device="cuda").to(dtype)} \
        if epilogue == "t" else \
        {"residual_add": torch.randn(b, h, w, cout, generator=g, device="cuda").to(dtype)}
    before = tqc.s8_conv3x3.launches
    got = tqc.s8_conv3x3(y8, sa, w8, ws, bias, out_dtype=dtype, **extra)
    assert tqc.s8_conv3x3.launches == before + 1
    want = tqc._plain_s8_conv3x3(y8, sa, w8, ws, bias, extra.get("time_add"),
                                 extra.get("residual_add"), dtype)
    assert torch.equal(got, want)
    one = torch.ones_like(sa), torch.ones_like(ws), torch.zeros_like(bias)
    acc = tqc.s8_conv3x3(y8, one[0], w8, one[1], one[2])
    exact = tqc._plain_s8_conv3x3(y8, one[0], w8, one[1], one[2], None, None,
                                  torch.float32)
    assert torch.equal(acc, exact)  # the integer sums


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s", [(2, 1024, 1024, 8, 40),
                                         (1, 1024, 1024, 1, 512),
                                         (2, 1000, 1000, 8, 40)])
def test_pv_int8_kernel_matches_plain_on_card(dtype, b, t, kv, h, s):
    """bf16 S = 40 takes the tensor-core path (s8 mma.sync for P.V); S = 512
    and float32 the FMA path.  Both keep the JAX package's kv blocks."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(b, n, h, s, generator=g, device="cuda").to(dtype)
               for n in (t, kv, kv))
    before = tfa.flash_attention_pv_int8.launches
    got = tfa.flash_attention_pv_int8(q, k, v, s**-0.5).float()
    assert tfa.flash_attention_pv_int8.launches == before + 1
    ref = tfa._plain_pv_int8(q.float(), k.float(), v.float(), s**-0.5)
    # a p or v code flips where scores or values lie within an ulp of a
    # rounding midpoint, moving an output by about 4/127; bf16 adds one
    # rounding of the output (2^-8 relative)
    err = (got - ref).abs()
    assert float(err.max()) <= (2e-3 if dtype == torch.float32 else 1e-2)
    assert float(err.norm() / ref.norm()) <= (1e-3 if dtype == torch.float32 else 5e-3)
