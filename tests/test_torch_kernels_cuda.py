"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the kernels have no CPU mode).  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ldm_tf2_tpu_torch.ops import fused_ffn as tff
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
