"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the kernels have no CPU mode).  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import chip_smoke
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
@pytest.mark.parametrize("shape,cout,whole", [((2, 32, 32, 320), 320, True),
                                              ((2, 8, 8, 640), 640, False)])
def test_int8_chain_counts_the_tpu_whole_chain_shapes(shape, cout, whole):
    """``gn_silu_conv3x3_int8`` is the two kernels back to back, and counts
    a chain only where the JAX package runs its whole-chain kernel."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    gamma, beta = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    w8, ws = tqc.int8_conv_weights(torch.randn(cout, c, 3, 3, generator=g, device="cuda"))
    bias = torch.randn(cout, generator=g, device="cuda")
    t = torch.randn(shape[0], cout, generator=g, device="cuda").to(torch.bfloat16)
    assert tqc.use_fused_int8_chain(shape[1] * shape[2], shape[2], c, cout, False) == whole
    before = tqc.gn_silu_conv3x3_int8.launches, tqc.s8_conv3x3.launches
    got = tqc.gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, bias, time_add=t)
    assert (tqc.gn_silu_conv3x3_int8.launches, tqc.s8_conv3x3.launches) == (
        before[0] + whole, before[1] + 1)
    y8, sa = tqc.gn_silu_quant(x, gamma, beta)
    assert torch.equal(got, tqc.s8_conv3x3(y8, sa, w8, ws, bias, time_add=t,
                                           out_dtype=x.dtype))


def _path(dtype, s):
    """The path a launch takes: wgmma for bf16 at the models' head dims
    (U-Net 40, 80, 160; autoencoder 512), mma.sync for other bf16 head dims
    that are a multiple of 8, the FMA path for float32 and the rest."""
    if dtype == torch.float32 or s % 8:
        return "fma"
    return "wgmma" if s in (40, 80, 160, 512) else "mma.sync"


def _took(wrapper, before):
    return {p: n - before[p] for p, n in wrapper.launches_by_path.items() if n - before[p]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s", [(2, 1024, 1024, 8, 40),
                                         (2, 256, 256, 8, 80),
                                         (2, 64, 64, 8, 160),
                                         (1, 1024, 1024, 1, 512),
                                         (3, 1024, 1024, 1, 512),
                                         (8, 1024, 1024, 1, 512),
                                         (2, 1024, 1000, 1, 512),
                                         (2, 1000, 999, 8, 40),
                                         (2, 100, 77, 4, 36),
                                         (2, 100, 77, 4, 64)])
def test_flash_kernel_matches_plain_on_card(dtype, b, t, kv, h, s):
    """bf16 S = 40, 80, 160 and 512 take the wgmma path, S = 64 the
    mma.sync path; S = 36 (not a multiple of 8) and float32 the FMA path."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, h, s, generator=g, device="cuda").to(dtype)
               for n in (t, kv, kv))
    before = flash_attention.launches
    paths = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, s**-0.5).float()
    assert flash_attention.launches == before + 1
    assert _took(flash_attention, paths) == {_path(dtype, s): 1}
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
    """bf16 takes the wgmma path at every width here (d = 384 too), float32
    the FMA path."""
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
@pytest.mark.parametrize("m,d", chip_smoke.FFN_SHAPES)
def test_ffn_wgmma_at_every_model_shape_on_card(m, d):
    """Every FFN of the sampling, serving and training paths (bf16) on the
    wgmma path, within ``chip_smoke.FFN_TOL`` of the plain version in
    float32, and two calls bit-equal (the split sums run in a fixed
    order)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1, m, d, generator=gen, device="cuda").bfloat16()
    args = _ffn_args(gen, d, torch.bfloat16)
    before = dict(tff.fused_ffn.launches_by_path)
    got, again = tff.fused_ffn(x, *args), tff.fused_ffn(x, *args)
    assert _took(tff.fused_ffn, before) == {"wgmma": 2}
    assert torch.equal(got, again)
    ref = tff._plain_ffn(x.float(), *[p.float() for p in args])
    tol_abs, tol_rel = chip_smoke.FFN_TOL["bfloat16"]
    diff = got.float() - ref
    assert float(diff.abs().max()) < tol_abs
    assert float(diff.norm() / ref.norm()) < tol_rel


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
    before = tqc.gn_silu_quant.launches, tqc.gn_silu_quant.stream_launches
    modes = dict(tqc.gn_silu_quant.launches_by_path)
    y8, sa = tqc.gn_silu_quant(x, gamma, beta)
    streamed = shape == (2, 64, 64, 320)  # the map beyond the TPU's one-pass slab
    assert (tqc.gn_silu_quant.launches, tqc.gn_silu_quant.stream_launches) == (
        before[0] + 1, before[1] + streamed)
    # the port re-reads where a cluster's shared memory cannot hold the image
    mode = tqc.gn_cluster_plan(shape, dtype, True)["mode"]
    assert mode == ("reread" if streamed else "resident")
    assert tqc.gn_silu_quant.launches_by_path[mode] == modes[mode] + 1
    r8, rsa = tqc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5)
    # float32 sums in another order: the scale to an ulp or two, the codes
    # to one step where a value lies within that of a rounding midpoint
    assert float(((sa - rsa).abs() / rsa).max()) <= 1e-6
    diff = (y8.int() - r8.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


def _kernel_launches(fn, what):
    """The kernels whose name holds ``what`` that one call of ``fn``
    launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and what in e.name]
    return names, out


@pytest.mark.cuda
def test_gn_silu_arithmetic_holds_on_every_float_on_card():
    """The facts rows 8 and 5 rest on, counted over every float of their
    range: the SiLU's reciprocal equals ``__frcp_rn`` on [1, 2^126), expf
    never decreases on [-104, 0], |silu(z)| stays below the amax bound for
    every z < 0."""
    _need_cuda()
    assert tqc.gn_silu_checks(torch.device("cuda")) == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,groups,mode", [
    (torch.bfloat16, (8, 32, 32, 640), 32, "resident"),   # the largest serving slab
    (torch.bfloat16, (8, 8, 8, 2560), 32, "resident"),
    (torch.bfloat16, (8, 64, 64, 320), 32, "reread"),     # row 9's map
    (torch.float32, (8, 8, 8, 640), 32, "resident"),
    (torch.bfloat16, (2, 5, 7, 96), 32, "resident"),
    (torch.bfloat16, (2, 5, 7, 36), 4, "resident"),      # 2-byte loads: C * 2 % 16 != 0
])
def test_gn_silu_quant_is_one_deterministic_cluster_launch_on_card(dtype, shape, groups, mode):
    """Rows 8 and 9 in one launch (the profiler's count) in the plan's mode,
    the same bits on every call, within the plain version's rounding."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device="cuda") * 0.5
    first = tqc.gn_silu_quant(x, gamma, beta, groups)
    before = dict(tqc.gn_silu_quant.launches_by_path)
    names, again = _kernel_launches(lambda: tqc.gn_silu_quant(x, gamma, beta, groups),
                                    "gn_silu_quant")
    assert len(names) == 1, names
    assert tqc.gn_silu_quant.launches_by_path[mode] == before[mode] + 2
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    r8, rsa = tqc._plain_gn_silu_quant(x, gamma, beta, groups, 1e-5)
    assert float(((again[1] - rsa).abs() / rsa).max()) <= 1e-6
    diff = (again[0].int() - r8.int()).abs()
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
@pytest.mark.parametrize("shape,cout,epilogue,path", [
    *((s_, c_, e_, "wgmma") for s_, c_, e_ in chip_smoke.SERVE_CHAINS),
    ((3, 8, 8, 640), 1280, "t", "wgmma"),  # a ragged M: a tile past the batch
    ((4, 8, 8, 96), 320, "residual", "wgmma"),  # Cin = 32 * 3: a zero-filled chunk
])
def test_s8_conv_paths_at_every_serve_shape_on_card(shape, cout, epilogue, path):
    """Every int8 conv of the serving path on the wgmma path, bit-equal to
    the plain version, and a Cin that is not a multiple of 128 or 64."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, w, cin = shape
    y8 = torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)
    w8 = torch.randint(-127, 128, (cout, 3, 3, cin), generator=g, device="cuda").to(torch.int8)
    sa = torch.rand(b, generator=g, device="cuda") * 0.01 + 1e-3
    ws = torch.rand(cout, generator=g, device="cuda") * 0.01 + 1e-3
    bias = torch.randn(cout, generator=g, device="cuda")
    extra = {"time_add": torch.randn(b, cout, generator=g, device="cuda").bfloat16()} \
        if epilogue == "t" else \
        {"residual_add": torch.randn(b, h, w, cout, generator=g, device="cuda").bfloat16()}
    before = dict(tqc.s8_conv3x3.launches_by_path)
    got = tqc.s8_conv3x3(y8, sa, w8, ws, bias, out_dtype=torch.bfloat16, **extra)
    assert _took(tqc.s8_conv3x3, before) == {path: 1}
    want = tqc._plain_s8_conv3x3(y8, sa, w8, ws, bias, extra.get("time_add"),
                                 extra.get("residual_add"), torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s", [(2, 1024, 1024, 8, 40),
                                         (1, 1024, 1024, 1, 512),
                                         (2, 1000, 1000, 8, 40)])
def test_pv_int8_kernel_matches_plain_on_card(dtype, b, t, kv, h, s):
    """bf16 S = 40 and 512 take the wgmma path (s8 wgmma for P.V), float32
    the FMA path.  Both keep the JAX package's kv blocks."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,tk,h,s", [(2, 1000, 8, 40), (2, 1024, 1, 512), (1, 300, 2, 80)])
def test_pv_int8_pre_pass_matches_its_plain_mirror_on_card(b, tk, h, s):
    """The wgmma path's pre-pass writes v8 (permuted, K-major, zero-padded)
    and sv exactly as ``_plain_v8`` lays them out."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(b, 64, h, s, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, tk, h, s, generator=g, device="cuda").bfloat16()
    scratch, v8_bytes = tfa.pv_int8_scratch(q, tk)
    scratch.fill_(77)  # every byte of v8 must be written
    before = tfa.flash_attention_pv_int8.launches_by_path["wgmma"]
    tfa._launch_pv_int8(q, v, v, s**-0.5, scratch=scratch)
    torch.cuda.synchronize()
    assert tfa.flash_attention_pv_int8.launches_by_path["wgmma"] == before + 1
    rows, keys = tfa.v8_layout(s, tk)
    v8 = scratch[:v8_bytes].view(torch.int8).reshape(b * h, rows, keys).cpu()
    sv = scratch[v8_bytes:].view(torch.float32).reshape(b * h, -1).cpu()
    want_v8, want_sv = tfa._plain_v8(v.float().cpu(), rows, keys)
    assert torch.equal(v8, want_v8)
    assert torch.equal(sv, want_sv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,path", [(torch.bfloat16, 40, "wgmma"),
                                          (torch.bfloat16, 512, "wgmma"),
                                          (torch.bfloat16, 64, "mma.sync"),
                                          (torch.float32, 40, "fma")])
def test_pv_int8_paths_on_card(dtype, s, path):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(1, 1024, 2, s, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    before = dict(tfa.flash_attention_pv_int8.launches_by_path)
    got = tfa.flash_attention_pv_int8(q, k, v, s**-0.5).float()
    took = {p: n - before[p] for p, n in tfa.flash_attention_pv_int8.launches_by_path.items()}
    assert took == {**dict.fromkeys(took, 0), path: 1}
    ref = tfa._plain_pv_int8(q.float(), k.float(), v.float(), s**-0.5)
    err = (got - ref).abs()
    assert float(err.max()) <= (2e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s,extreme", [(2, 1024, 1024, 8, 40, False),
                                                 (2, 256, 256, 8, 80, False),
                                                 (2, 64, 64, 8, 160, False),
                                                 (1, 1024, 1024, 1, 512, False),
                                                 (3, 1024, 1024, 1, 512, False),
                                                 (8, 1024, 1024, 1, 512, False),
                                                 (2, 1000, 999, 1, 512, False),
                                                 (2, 1000, 999, 8, 40, True),
                                                 (2, 100, 77, 4, 36, False),
                                                 (2, 100, 77, 4, 64, False)])
def test_flash_backward_kernels_match_plain_on_card(dtype, b, t, kv, h, s, extreme):
    """The forward's lse and the dq and dk/dv kernels against their plain
    versions on the forward's own residuals.  ``extreme``: logits near
    -160 over a ragged kv, where an unmasked padded key overflows exp()."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(b, n, h, s, generator=g, device="cuda")
                   for n in (t, kv, kv, t))
    if extreme:
        q, k = q + 5.0, k - 5.0
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    scale = s**-0.5
    counts = (tfa.flash_attention.launches, tfa.flash_backward_dq.launches,
              tfa.flash_backward_dkv.launches)
    wrappers = (tfa.flash_attention, tfa.flash_backward_dq, tfa.flash_backward_dkv)
    paths = [dict(w.launches_by_path) for w in wrappers]
    out, lse = tfa._launch(q, k, v, scale, with_lse=True)
    _, ref_lse = tfa._plain_forward(q.float(), k.float(), v.float(), scale)
    di = tfa._di(out, do)
    dq = tfa.flash_backward_dq(q, k, v, do, lse, di, scale)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, di, scale)
    assert (tfa.flash_attention.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == tuple(c + 1 for c in counts)
    for w, before in zip(wrappers, paths):
        assert _took(w, before) == {_path(dtype, s): 1}
    args = (q.float(), k.float(), v.float(), do.float(), lse, di, scale)
    ref = (tfa._plain_dq(*args), *tfa._plain_dkv(*args))
    # lse: float32 in both; f32 gradients: summation order only; bf16: one
    # rounding of each output (2^-9 relative) on the same residuals
    assert float((lse - ref_lse).abs().max()) < 1e-4
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in zip((dq, dk, dv), ref):
        assert bool(torch.isfinite(got.float()).all())
        assert float((got.float() - want).norm() / want.norm()) < tol


@pytest.mark.cuda
def test_unet_gradients_on_card_equal_cpu():
    """Every parameter gradient of a tiny U-Net on the card equals the
    CPU's for the same weights (float32, TF32 off), each tensor within 1e-4
    rel-L2 of its own norm, so a small gradient (the q and k projections',
    through the dq and dk kernels) is held as tightly as a large one.
    Before the kernels were autograd Functions the card returned none
    through self-attention and the FFN: the q, k, v, out, GEGLU and
    layernorm3 parameters had no gradient, and everything upstream of them
    a wrong one.  The weights are drawn once, on the CPU: one seed gives
    different draws on a CPU and a CUDA generator."""
    _need_cuda()
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.models import UNet

    factory.set_float32_precision()
    g = torch.Generator().manual_seed(1)
    x, ctx = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 7, 32, generator=g)
    t = torch.tensor([10.0, 500.0])
    kwargs = dict(model_channels=64, num_blocks=1, channel_mult=(1, 2), num_heads=2,
                  context_channels=32, dropout_rate=0.0)
    weights = factory.init_params_(UNet(**kwargs), seed=3).state_dict()
    grads = {}
    for device in ("cpu", "cuda"):
        with torch.device(device):
            unet = UNet(**kwargs)
        unet.load_state_dict(weights)
        before = tfa.flash_backward_dq.launches
        out = unet(x.to(device), t.to(device), ctx.to(device), training=True)
        names, params = zip(*unet.named_parameters())
        got = torch.autograd.grad((out**2).mean(), params, allow_unused=True)
        grads[device] = dict(zip(names, got))
        if device == "cuda":  # 4 spatial self-attentions
            assert tfa.flash_backward_dq.launches == before + 4
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        assert float(want.norm()) > 0, name
        rel = float((got.cpu() - want).norm() / want.norm())
        assert rel < 1e-4, (name, rel)


@pytest.mark.cuda
def test_int8_kernels_refuse_grad_on_card():
    _need_cuda()
    q = torch.randn(1, 64, 2, 40, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="sampling-only"):
        tfa.flash_attention_pv_int8(q, q, q, 0.2)
    x = torch.randn(1, 8, 8, 64, device="cuda")
    gamma = torch.ones(64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="sampling-only"):
        tqc.gn_silu_quant(x, gamma, torch.zeros(64, device="cuda"))


# ---------------------------- the opt-in kernels (GroupNorm, chain, cross) --

def _switches(groupnorm, conv, cross):
    from ldm_tf2_tpu_torch.ops.attention import set_packed_cross
    from ldm_tf2_tpu_torch.ops.fused_conv import set_fused_conv_impl
    from ldm_tf2_tpu_torch.ops.group_norm import set_groupnorm_impl

    set_groupnorm_impl(groupnorm)
    set_fused_conv_impl(conv)
    set_packed_cross(cross)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,activate", [((4, 32, 32, 320), False),
                                            ((4, 4, 4, 1280), True),
                                            ((2, 256, 256, 128), True)])
def test_group_norm_kernels_match_plain_on_card(dtype, shape, activate):
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    g = torch.Generator(device="cuda").manual_seed(20)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device="cuda") * 0.5
    before = (tgn.group_norm_fused.launches, tgn.group_stats.launches)
    y = tgn.group_norm_fused(x, gamma, beta, 32, 1e-6, activate)
    mean, rstd = tgn.group_stats(x, 32, 1e-6)
    torch.cuda.synchronize()
    assert (tgn.group_norm_fused.launches, tgn.group_stats.launches) == \
        (before[0] + 1, before[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert _rel(y, tgn._plain_group_norm_fused(x, gamma, beta, 32, 1e-6, activate)) < tol
    want_mean, want_rstd = tgn._plain_group_stats(x, 32, 1e-6)
    assert _rel(mean, want_mean) < 1e-5 and _rel(rstd, want_rstd) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,activate", [
    ((4, 32, 32, 320), 32, False), ((4, 16, 16, 640), 32, False), ((4, 4, 4, 1280), 32, True),
    ((2, 32, 32, 512), 32, False), ((2, 256, 256, 128), 32, True), ((2, 5, 7, 96), 32, True),
    ((2, 5, 7, 36), 4, False)])
def test_group_norm_fused_is_one_deterministic_cluster_launch_on_card(dtype, shape, groups,
                                                                      activate):
    """Row 5 in one launch (the profiler's count) in the plan's mode (the
    autoencoder's 256^2 map re-read), the same bits on every call, within
    ``chip_smoke.OPT_TOL`` of the plain version."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    g = torch.Generator(device="cuda").manual_seed(22)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device="cuda") * 0.5
    first = tgn.group_norm_fused(x, gamma, beta, groups, 1e-6, activate)
    mode = tqc.gn_cluster_plan(shape, dtype, False, groups)["mode"]
    assert mode == ("reread" if shape == (2, 256, 256, 128) else "resident")
    before = dict(tgn.group_norm_fused.launches_by_path)
    names, again = _kernel_launches(
        lambda: tgn.group_norm_fused(x, gamma, beta, groups, 1e-6, activate), "gn_cluster_norm")
    assert len(names) == 1, names
    assert tgn.group_norm_fused.launches_by_path[mode] == before[mode] + 2
    assert torch.equal(first, again)
    want = tgn._plain_group_norm_fused(x, gamma, beta, groups, 1e-6, activate)
    assert _rel(again, want) < chip_smoke.OPT_TOL[str(dtype).split(".")[-1]]


@pytest.mark.cuda
@pytest.mark.parametrize("activate", [False, True])
def test_group_norm_fused_gradients_on_card_equal_cpu(activate):
    """Row 5 as an ``autograd.Function``: the card's forward is the cluster
    kernel, its backward the recompute through ``_xla_group_norm``; x's,
    gamma's and beta's gradients within 1e-4 rel-L2 of the CPU's in
    float32."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    g = torch.Generator().manual_seed(23)
    x = torch.randn(2, 16, 16, 128, generator=g) * 2 + 0.3
    gamma, beta = torch.randn(128, generator=g) * 0.1 + 1.0, torch.randn(128, generator=g) * 0.1
    dy = torch.randn(2, 16, 16, 128, generator=g)
    grads = {}
    for device in ("cpu", "cuda"):
        args = [t.to(device).requires_grad_(True) for t in (x, gamma, beta)]
        before = tgn.group_norm_fused.launches
        out = tgn.group_norm_fused(*args, 32, 1e-5, activate)
        grads[device] = torch.autograd.grad(out, args, dy.to(device))
        assert tgn.group_norm_fused.launches - before == (device == "cuda")
    for want, got in zip(grads["cpu"], grads["cuda"]):
        assert float((got.cpu() - want).norm() / want.norm()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 32, 32, 320), (4, 4, 4, 1280), (2, 256, 256, 128),
                                   (2, 5, 7, 96)])
def test_group_stats_is_one_deterministic_launch_on_card(dtype, shape):
    """Row 6 in one kernel launch (the profiler's count), the same bits on
    every call, within the plain version's float32 rounding."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    g = torch.Generator(device="cuda").manual_seed(21)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    first = torch.cat(tgn.group_stats(x, 32, 1e-6))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = torch.cat(tgn.group_stats(x, 32, 1e-6))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "stats" in e.name]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert torch.equal(first, again)
    want = torch.cat(tgn._plain_group_stats(x, 32, 1e-6))
    assert _rel(again, want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,epilogue", [((4, 32, 32, 320), 320, "t"),
                                                 ((4, 4, 4, 2560), 1280, "t"),
                                                 ((4, 8, 8, 1280), 1280, "residual"),
                                                 ((2, 64, 64, 512), 256, None),
                                                 ((2, 8, 8, 48), 64, "t"),
                                                 ((3, 5, 7, 128), 136, "residual"),
                                                 ((2, 8, 8, 96), 64, "t")])
def test_chain_kernel_matches_plain_on_card(dtype, shape, cout, epilogue):
    """On the path ``conv_plan`` names: wgmma for bf16 with Cin % 64 == 0
    (a ragged map and N included: TMA's zero fill is the SAME border and
    the tile's tail), mma.sync for Cin = 96, FMA for float32 and for Cin =
    48 (48 % 32 != 0, 16 groups)."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import fused_conv as tfc

    g = torch.Generator(device="cuda").manual_seed(21)
    b, h, w, cin = shape
    groups = 16 if cin % 32 else 32
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    gamma = torch.randn(cin, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(cin, generator=g, device="cuda") * 0.5
    wk = (torch.randn(cout, cin, 3, 3, generator=g, device="cuda") * (9 * cin) ** -0.5
          ).to(dtype)
    bias = (torch.randn(cout, generator=g, device="cuda") * 0.1).to(dtype)
    extra = {}
    if epilogue == "t":
        extra["time_add"] = torch.randn(b, cout, generator=g, device="cuda").to(dtype)
    elif epilogue == "residual":
        extra["residual_add"] = torch.randn(b, h, w, cout, generator=g,
                                            device="cuda").to(dtype)
    before = tfc.gn_silu_conv3x3_fused.launches
    paths = dict(tfc.gn_silu_conv3x3_fused.launches_by_path)
    got = tfc.gn_silu_conv3x3_fused(x, gamma, beta, wk, bias, num_groups=groups, **extra)
    want = tfc._plain_chain(x, gamma, beta, wk, bias, extra.get("time_add"),
                            extra.get("residual_add"), groups, 1e-5)
    torch.cuda.synchronize()
    assert tfc.gn_silu_conv3x3_fused.launches == before + 1
    assert _took(tfc.gn_silu_conv3x3_fused, paths) == {
        tfc.conv_plan(shape, cout, dtype)["path"]: 1}
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,kv,h,s", [(4, 1024, 77, 8, 40), (4, 64, 77, 8, 160),
                                        (2, 100, 128, 2, 64), (1, 33, 5, 1, 24),
                                        (4, 256, 77, 8, 80), (2, 100, 80, 2, 40),
                                        (1, 33, 5, 1, 80)])
def test_cross_kernel_matches_plain_on_card(dtype, b, t, kv, h, s):
    """On the path ``cross_plan`` names: wgmma for bf16 at the U-Net's head
    dims with at most 80 keys (ragged query tiles and 5 keys included),
    mma.sync for other bf16 shapes, FMA for float32."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import cross_attention as tca

    g = torch.Generator(device="cuda").manual_seed(22)
    q, k, v = (torch.randn(b, n, h, s, generator=g, device="cuda").to(dtype)
               for n in (t, kv, kv))
    before = tca.cross_attention.launches
    paths = dict(tca.cross_attention.launches_by_path)
    got = tca.cross_attention(q, k, v, s**-0.5)
    want = tca._plain_cross_attention(q, k, v, s**-0.5)
    torch.cuda.synchronize()
    assert tca.cross_attention.launches == before + 1
    assert _took(tca.cross_attention, paths) == {
        tca.cross_plan(b, t, kv, h, s, dtype)["path"]: 1}
    assert _rel(got, want) < (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_cross_wgmma_with_scores_far_below_the_row_max_on_card():
    """Scores 30x wider than the U-Net's: many p fall below 2^-64, so tiles
    take the exact division's slow branch (a warp vote) and masked keys give
    p = 0; the result stays within the bf16 tolerance on wgmma."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import cross_attention as tca

    g = torch.Generator(device="cuda").manual_seed(25)
    q, k, v = (torch.randn(4, n, 8, 40, generator=g, device="cuda") for n in (1024, 77, 77))
    q, k, v = (q * 30).bfloat16(), k.bfloat16(), v.bfloat16()
    paths = dict(tca.cross_attention.launches_by_path)
    got = tca.cross_attention(q, k, v, 40**-0.5)
    want = tca._plain_cross_attention(q, k, v, 40**-0.5)
    torch.cuda.synchronize()
    assert _took(tca.cross_attention, paths) == {"wgmma": 1}
    assert _rel(got, want) < 1e-2


@pytest.mark.cuda
def test_cross_row_division_is_div_rn_on_card():
    """The wgmma path divides p by the row sum with one reciprocal per row
    (``div_by_row``); every quotient must carry div.rn.f32's bits: p over
    [0, 1] on a log scale down to 2^-149 and 0, l over [1, 80]."""
    _need_cuda()
    import ctypes

    from ldm_tf2_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(23)
    n = 1 << 22
    p = torch.exp2(-torch.rand(n, generator=g, device="cuda") * 160).clamp_max(1.0)
    p[:4096] = torch.rand(4096, generator=g, device="cuda")  # the common range
    p[4096:4100] = torch.tensor([0.0, 1.0, 2.0**-64, 2.0**-149], device="cuda")
    l = 1.0 + torch.rand(n, generator=g, device="cuda") * 79
    mismatches = torch.zeros(1, dtype=torch.int32, device="cuda")
    fn = _build.entry("cross_attention", "ldm_cross_div_check",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p])
    err = fn(p.data_ptr(), l.data_ptr(), n, mismatches.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "div check")
    assert int(mismatches.item()) == 0


@pytest.mark.cuda
def test_chain_wgmma_relayout_cache_and_split_order_on_card():
    """The wgmma conv relays a weight once per version and repeats its bits
    (split-K partials added in split order); an in-place update relays
    again and changes the result as the plain version does."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import fused_conv as tfc

    g = torch.Generator(device="cuda").manual_seed(24)
    shape, cout = (4, 8, 8, 1920), 1280
    assert tfc.conv_plan(shape, cout, torch.bfloat16)["splits"] > 1
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    gamma, beta = torch.ones(1920, device="cuda"), torch.zeros(1920, device="cuda")
    w = (torch.randn(cout, 1920, 3, 3, generator=g, device="cuda") * 0.01).bfloat16()
    bias = torch.zeros(cout, device="cuda").bfloat16()
    count = tfc.gn_silu_conv3x3_fused.relayouts
    first = tfc.gn_silu_conv3x3_fused(x, gamma, beta, w, bias)
    again = tfc.gn_silu_conv3x3_fused(x, gamma, beta, w, bias)
    assert tfc.gn_silu_conv3x3_fused.relayouts == count + 1
    assert torch.equal(first, again)
    w.mul_(-1)  # a version bump: relaid again, and the output flips sign
    flipped = tfc.gn_silu_conv3x3_fused(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    assert tfc.gn_silu_conv3x3_fused.relayouts == count + 2
    assert torch.equal(flipped, -first)


@pytest.mark.cuda
def test_near_constant_group_on_card_clamps_only_in_the_chain():
    """Two values whose float32 fast variance is exactly -1.0 in any
    summation order (see tests/test_torch_fused_kernels.py): with eps = 4
    the GroupNorm kernels give rstd = 3^-0.5, the chain 4^-0.5."""
    _need_cuda()
    from ldm_tf2_tpu_torch.ops import fused_conv as tfc
    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    pair = torch.tensor([2.828951120376587, 2.828312635421753]) * 1024.0
    x = pair[None, None, :, None].expand(1, 1, 2, 64).contiguous().cuda()
    _, rstd = tgn.group_stats(x, 32, 4.0)
    assert torch.allclose(rstd, torch.full_like(rstd, 3.0**-0.5), rtol=1e-6)
    w = torch.zeros(64, 64, 3, 3, device="cuda")
    w[:, :, 1, 1] = torch.eye(64, device="cuda")
    ones, zeros = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    got = tfc.gn_silu_conv3x3_fused(x, ones, zeros, w, zeros, eps=4.0)
    d = float(pair[0] - pair[1]) / 2.0
    want = d * 0.5 / (1.0 + torch.exp(torch.tensor(-d * 0.5)))
    assert abs(float(got[0, 0, 0, 0]) - float(want)) < 1e-4


@pytest.mark.cuda
def test_unet_gradients_with_the_opt_in_kernels_on_card_equal_cpu():
    """The tiny U-Net's parameter gradients with all three switches on:
    the card runs the four kernels forward and recomputes through their
    plain versions backward; the CPU runs the plain versions throughout.
    Each tensor within 1e-4 rel-L2 of its own norm."""
    _need_cuda()
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.models import UNet
    from ldm_tf2_tpu_torch.ops import cross_attention as tca
    from ldm_tf2_tpu_torch.ops import fused_conv as tfc
    from ldm_tf2_tpu_torch.ops import group_norm as tgn

    factory.set_float32_precision()
    g = torch.Generator().manual_seed(2)
    x, ctx = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 7, 32, generator=g)
    t = torch.tensor([10.0, 500.0])
    kwargs = dict(model_channels=64, num_blocks=1, channel_mult=(1, 2), num_heads=2,
                  context_channels=32, dropout_rate=0.0)
    weights = factory.init_params_(UNet(**kwargs), seed=4).state_dict()
    grads = {}
    counters = (tgn.group_norm_fused, tfc.gn_silu_conv3x3_fused, tca.cross_attention)
    _switches("pallas", "pallas", True)
    try:
        for device in ("cpu", "cuda"):
            with torch.device(device):
                unet = UNet(**kwargs)
            unet.load_state_dict(weights)
            before = [fn.launches for fn in counters]
            out = unet(x.to(device), t.to(device), ctx.to(device), training=True)
            names, params = zip(*unet.named_parameters())
            got = torch.autograd.grad((out**2).mean(), params, allow_unused=True)
            grads[device] = dict(zip(names, got))
            if device == "cuda":  # 16 chains, 5 GroupNorms, 4 cross-attentions
                assert [fn.launches - b for fn, b in zip(counters, before)] == [5, 16, 4]
    finally:
        _switches("auto", "auto", False)
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None, name
        assert float(want.norm()) > 0, name
        assert float((got.cpu() - want).norm() / want.norm()) < 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(2048, 320), (1000, 640), (256, 1280), (64, 64)])
def test_int8_ffn_kernel_matches_plain_on_card(dtype, m, d):
    """Row 4 against ``_plain_ffn_int8`` on the same inputs: the
    LayerNorm's summation order differs, which flips a code in a few rows
    (moving each by up to about 3e-2); bf16 also rounds the output."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    lns, lnb, w1v, b1v, w1g, b1g, w2, b2 = _ffn_args(g, d, dtype)
    x = torch.randn(1, m, d, generator=g, device="cuda").to(dtype)
    q = tff.quantize_ffn_weights(w1v, w1g, w2)
    before = tff.fused_ffn_int8.launches
    got = tff.fused_ffn_int8(x, lns, lnb, q, b1v, b1g, b2).float()
    assert tff.fused_ffn_int8.launches == before + 1
    ref = tff._plain_ffn_int8(x, lns, lnb, q, b1v, b1g, b2).float()
    rel = float((got - ref).norm() / ref.norm())
    assert rel < (1e-3 if dtype == torch.float32 else 5e-3)
    assert float((got - ref).abs().max()) < 0.1


def _int8_ffn_on_card(dtype, m, d, f, seed):
    """(the kernel's output, a second call's, the plain version's, the
    launches by path of the first call) on inputs made from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    x = randn(1, m, d).to(dtype)
    lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
    w1v, w1g = (randn(d, f, scale=d**-0.5).to(dtype) for _ in range(2))
    w2 = randn(f, d, scale=f**-0.5).to(dtype)
    b1v, b1g, b2 = (randn(n, scale=0.1).to(dtype) for n in (f, f, d))
    q = tff.quantize_ffn_weights(w1v, w1g, w2)
    args = (x, lns, lnb, q, b1v, b1g, b2)
    before = tff.fused_ffn_int8.launches, dict(tff.fused_ffn_int8.launches_by_path)
    got = tff.fused_ffn_int8(*args)
    assert tff.fused_ffn_int8.launches == before[0] + 1
    took = _took(tff.fused_ffn_int8, before[1])
    again = tff.fused_ffn_int8(*args)
    want = tff._plain_ffn_int8(*args)
    torch.cuda.synchronize()
    return got.float(), again.float(), want.float(), took


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", chip_smoke.FFN8_SHAPES)
def test_int8_ffn_is_one_deterministic_wgmma_launch_on_card(dtype, m, d):
    """Row 4 at every ``FFN8_SHAPES`` shape: one launch on the wgmma path
    (one thread-block cluster per 64 rows), two calls bit-equal, within
    ``FFN8_TOL`` of the plain version, and at most ``FFN8_FLIP_ROWS`` of
    rows moved by a code flip (the LayerNorm's summation order)."""
    _need_cuda()
    got, again, want, took = _int8_ffn_on_card(dtype, m, d, 4 * d, seed=31)
    assert took == {"wgmma": 1}
    assert torch.equal(got, again)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    assert float((got - want).norm() / want.norm()) <= chip_smoke.FFN8_TOL[name]
    assert float((got - want).abs().max()) <= 0.1
    flipped = float(((got - want).abs().amax(dim=-1) > 1e-3).float().mean())
    assert flipped <= chip_smoke.FFN8_FLIP_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f", [(300, 96, 352), (130, 32, 32), (256, 1280, 8192),
                                   (70, 1280, 1024)])
def test_int8_ffn_odd_plans_on_card(dtype, m, d, f):
    """The plan's other cases: a ragged last hidden tile (F % 64 == 32), one
    CTA a cluster, u in the device workspace ("spill": F = 8192 at d =
    1280 does not fit a cluster of 16), an F that is not 4d; each against
    the plain version within ``FFN8_TOL``, two calls bit-equal."""
    _need_cuda()
    plan = tff.ffn8_plan(m, d, f, dtype)
    assert plan["resident"] == (f != 8192)
    got, again, want, took = _int8_ffn_on_card(dtype, m, d, f, seed=32)
    assert took == {"wgmma": 1}
    assert torch.equal(got, again)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    assert float((got - want).norm() / want.norm()) <= chip_smoke.FFN8_TOL[name]
    assert float((got - want).abs().max()) <= 0.1


@pytest.mark.cuda
def test_ae_train_step_on_card_equals_cpu():
    """One phase-2 AE train step (VQ, attention on, S = 128) in float32: each
    gradient tensor of both models and each of the discriminator's running
    statistics, card against CPU, within 1e-4 rel-L2 of its own norm
    (summation order).  A tensor whose CPU value is zero up to rounding
    (below 1e-8 of its group's norm: the attention's key bias, whose
    gradient softmax cancels exactly, at 2e-10 to 1.5e-9; the smallest real
    one here, the codebook's, is at 4.7e-6) must be zero up to rounding on
    the card too, below 1e-7 of the group's norm.  64 channels
    keep two per GroupNorm group: with one, every conv bias before a
    GroupNorm has a gradient of exactly 0, which both devices return as
    cancellation noise."""
    _need_cuda()
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.models import LPIPS, AutoencoderVQ, Discriminator
    from ldm_tf2_tpu_torch.training import ae_trainer as tat

    factory.set_float32_precision()
    kwargs = dict(channels=64, num_blocks=1, multipliers=(1, 2), attention_resolutions=(8,),
                  vocab_size=64, resolution=16)
    weights = [factory.init_params_(m, seed).state_dict() for seed, m in
               enumerate((AutoencoderVQ(**kwargs), Discriminator(16, 2), LPIPS()))]
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    out = {}
    for device in ("cpu", "cuda"):
        with torch.device(device):
            models = (AutoencoderVQ(**kwargs), Discriminator(16, 2), LPIPS())
        for m, w in zip(models, weights):
            m.load_state_dict(w)
        ae, disc, lpips = models
        lpips.requires_grad_(False)
        opt = tat.make_adam(1e-4)
        _, step2 = tat.make_ae_train_steps(ae, disc, lpips, opt, opt,
                                           discriminator_weight=0.6)
        before = tfa.flash_backward_dq.launches
        grads, d_grads, metrics = step2.grads(tat.init_ae_train_state(ae, disc, opt, opt),
                                              x.to(device))
        if device == "cuda":  # 5 attentions, each differentiated once
            assert tfa.flash_backward_dq.launches - before == 5
        out[device] = ([g.cpu() for g in grads], [g.cpu() for g in d_grads],
                       [b.cpu() for b in disc.buffers()], metrics)
        names = ([n for n, _ in ae.named_parameters()],
                 [n for n, _ in disc.named_parameters()], [n for n, _ in disc.named_buffers()])
    for part, group in enumerate(("autoencoder grads", "discriminator grads",
                                  "running statistics")):
        total = float(torch.cat([t.flatten() for t in out["cpu"][part]]).norm())
        ratios = []  # error over its bound, per tensor
        for n, got, want in zip(names[part], out["cuda"][part], out["cpu"][part]):
            if float(want.norm()) < 1e-8 * total:
                ratios.append((float(got.norm()) / (1e-7 * total), n))
            else:
                ratios.append((float((got - want).norm()) / (1e-4 * float(want.norm())), n))
        ratios.sort(reverse=True)
        assert ratios[0][0] < 1.0, (group, ratios[:4])
    for k, want in out["cpu"][3].items():  # relative, or to 1e-3 for a loss near 0
        bound = 1e-4 * max(abs(float(want)), 1e-3)
        assert abs(float(out["cuda"][3][k]) - float(want)) <= bound, k
