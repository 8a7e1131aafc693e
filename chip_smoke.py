#!/usr/bin/env python3
"""Drive the PyTorch port (ldm_tf2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the
final line is printed:

1. device: the card's name and power limit (nvidia-smi), CUDA present;
2. build: the five CUDA sources compiled from ldm_tf2_tpu_torch/csrc with
   nvcc, one process each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with its time, the plain version's time,
   the card's bound and, where one PyTorch call computes a comparable
   function, that call's time as a yardstick (attention: SDPA; the s8
   conv: cuDNN's float32 conv of the same codes, and the bf16 GN -> SiLU
   -> conv chain that int8 replaces);
4. unet: one full-width U-Net eval (CFG batch 4, 32x32 latent, seeded
   weights) on the card against the same weights on the CPU in float32,
   plain and in the int8 serving modes;
5. main path: 50-step CFG DDIM txt2img at the north-star config (batch 2,
   256^2, seeded full-width weights, bf16), through ``sample_txt2img``,
   with the kernels' launch counts read around that one run; then a
   torch.profiler window over a few U-Net evals (device time by kernel
   group, idle share);
6. serve: the JSONL server (``cli/serve_ldm.serve``) in the int8 serving
   modes (``tpu.quantize: int8``, ``quantize_attention: int8pv``) at the
   north-star widths, batch 4, 50 steps, on four requests from an
   in-memory stream, with the launch counts read around it and held to
   what the north-star U-Net dispatches (``SERVE_EVAL``).

The last lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor
# cores, float32 outside the tensor cores (the kernels' float32 path and
# elementwise work use FMAs), and HBM bandwidth.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
KERNELS = ("flash_attention", "fused_ffn", "gn_silu_quant", "s8_conv3x3",
           "flash_attention_pv_int8")

# (B, Tq, Tk, H, S): the main path's self-attentions (CFG batch 4), then
# the serve path's bf16 ones (CFG batch 8; its level-0 ones take int8 P.V)
ATTN_SHAPES = [
    (4, 1024, 1024, 8, 40), (4, 256, 256, 8, 80), (4, 64, 64, 8, 160),
    (4, 16, 16, 8, 160), (2, 1024, 1024, 1, 512), (4, 1000, 1000, 8, 40),
    (8, 256, 256, 8, 80), (8, 64, 64, 8, 160), (8, 16, 16, 8, 160),
]
# (M, d): the main path's FFNs (CFG batch 4), then the serve path's (batch 8)
FFN_SHAPES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280),
              (8192, 320), (2048, 640), (512, 1280), (128, 1280)]
# ([B, H, W, Cin], Cout, epilogue): the distinct ResBlock chains of the
# north-star U-Net that the int8 gate quantizes at the serve path's CFG
# batch 8 (tests/test_torch_int8.py holds the gate to the JAX package's on
# every chain), and what one U-Net eval there dispatches: 29 int8 chains,
# 16 spatial self-attentions of which the 5 at level 0 (1024 tokens) take
# int8 P.V, 16 FFNs.  The autoencoder's decode adds one int8-P.V attention.
SERVE_CHAINS = [
    ((8, 32, 32, 320), 320, "t"), ((8, 32, 32, 320), 320, "residual"),
    ((8, 16, 16, 320), 640, "t"), ((8, 16, 16, 640), 640, "residual"),
    ((8, 16, 16, 640), 640, "t"), ((8, 8, 8, 640), 1280, "t"),
    ((8, 8, 8, 1280), 1280, "residual"), ((8, 8, 8, 1280), 1280, "t"),
    ((8, 8, 8, 2560), 1280, "t"), ((8, 8, 8, 1920), 1280, "t"),
    ((8, 16, 16, 1920), 640, "t"), ((8, 16, 16, 1280), 640, "t"),
    ((8, 16, 16, 960), 640, "t"), ((8, 32, 32, 640), 320, "t"),
]
SERVE_EVAL = {"int8_chains": 29, "self_attentions": 16, "pv_int8": 5, "ffn": 16}

# Tolerances against the plain version computed in float32 from the same
# inputs.  float32: only summation order differs.  bfloat16: the kernel
# rounds its output (and the FFN its LN output and hidden activation) to
# bfloat16, about 2^-9 relative each.
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 1e-2)}  # (max abs, rel L2)
FFN_TOL = {"float32": (1e-3, 1e-5), "bfloat16": (1e-1, 1e-2)}
# int8-P.V: a p or v code flips where a score or value lies within an ulp of
# a rounding midpoint, moving an output by about 4/127 of the block's |v|
# range; bf16 adds one rounding of the output.
PV_TOL = {"float32": (2e-3, 1e-3), "bfloat16": (1e-2, 5e-3)}  # (max abs, rel L2)
# Full-width U-Net, card vs CPU float32: float32 differs in summation order
# through ~70 layers; bfloat16 stores weights and activations in 8 bits of
# mantissa throughout.  In the int8 modes summation order also flips a code
# where a value lies within float32 noise of a rounding midpoint; the flip
# moves its 3x3 neighbourhood by a whole step, and later chains' rounding
# turns that into more flips.  The card must still agree with the CPU at
# least twice as closely as the int8 modes move the output (rel-L2 2.7e-3
# on these weights), so that the check sees a missing or wrong int8 route.
UNET_TOL = {"float32": 1e-3, "bfloat16": 1e-1, "int8 float32": 1.3e-3}  # rel L2

NORTH_STAR = {
    "cond_stage_model": dict(vocab_size=30522, encoder_stack_size=32,
                             hidden_size=1280, num_heads=8, size_per_head=64,
                             max_seq_len=77, filter_size=5120,
                             dropout_rate=0.1),
    "unet": dict(model_channels=320, out_channels=4, num_blocks=2,
                 attention_resolutions=[4, 2, 1], dropout_rate=0.1,
                 channel_mult=[1, 2, 4, 4], num_heads=8),
    "autoencoder_kl": dict(latent_channels=4, channels=128, num_blocks=2,
                           attention_resolutions=[], dropout_rate=0.0,
                           multipliers=[1, 2, 4, 4], resample_with_conv=True),
    "ldm": dict(num_steps=1000, beta_start=0.00085, beta_end=0.012,
                v_posterior=0.0, scale_factor=0.18215, eta=0.0,
                num_ddim_steps=50, timestep_spacing="uniform"),
    "ldm_sampling": dict(guidance_scale=5.0, guidance_rescale=0.0,
                         latent_shape=[2, 32, 32, 4],
                         text_prompt="a virus monster is playing guitar, "
                                     "oil on canvas",
                         vocab_dir="bert_model", autoencoder_type="kl"),
    "tpu": dict(compute_dtype="bfloat16", weights_dtype="bfloat16"),
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got, ref):
    diff = (got.float() - ref.float())
    max_abs = float(diff.abs().max())
    rel_l2 = float(diff.norm() / ref.float().norm().clamp_min(1e-30))
    return max_abs, rel_l2


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops.attention import dot_product_attention
    from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention
    from ldm_tf2_tpu_torch.ops.fused_ffn import _plain_ffn, fused_ffn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {name: [] for name in KERNELS}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, tq, tk, h, s in ATTN_SHAPES:
            q, k, v = (randn(b, t, h, s).to(dtype) for t in (tq, tk, tk))
            scale = s**-0.5
            got = flash_attention(q, k, v, scale)
            ref = dot_product_attention(q.float(), k.float(), v.float(), scale)
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = ATTN_TOL[name]
            ok = max_abs < tol_abs and rel < tol_rel
            ms = time_ms(lambda: flash_attention(q, k, v, scale))
            plain = time_ms(lambda: dot_product_attention(q, k, v, scale))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            bms, by = bound_ms(nbytes, 4.0 * b * h * tq * tk * s, name)
            row = dict(shape=[b, tq, tk, h, s], dtype=name, max_abs_err=max_abs,
                       rel_l2=rel, ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bms, bound_by=by)
            results["flash_attention"].append(row)
            log(f"flash_attention {name} q[{b},{tq},{h},{s}] kv {tk}: max_abs "
                f"{max_abs:.3e} (tol {tol_abs:g}) rel_l2 {rel:.3e} (tol "
                f"{tol_rel:g}) {'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
                f"{plain:.4f} sdpa {lib:.4f} bound {bms:.4f} ({by})")
        for m, d in FFN_SHAPES:
            f = 4 * d
            x = randn(1, m, d).to(dtype)
            lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
            ws = [randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
                  randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
                  randn(f, d, scale=f**-0.5), randn(d, scale=0.1)]
            ws = [w.to(dtype) for w in ws]
            got = fused_ffn(x, lns, lnb, *ws)
            ref = _plain_ffn(x.float(), lns, lnb, *[w.float() for w in ws])
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = FFN_TOL[name]
            ok = max_abs < tol_abs and rel < tol_rel
            ms = time_ms(lambda: fused_ffn(x, lns, lnb, *ws))
            plain = time_ms(lambda: _plain_ffn(x, lns, lnb, *ws))
            nbytes = (2 * x.numel() + sum(w.numel() for w in ws)) * x.element_size() \
                + 2 * d * 4
            bms, by = bound_ms(nbytes, 6.0 * m * d * f, name)
            row = dict(shape=[m, d], dtype=name, max_abs_err=max_abs,
                       rel_l2=rel, ok=ok, ms=ms, plain_ms=plain, library_ms=None,
                       bound_ms=bms, bound_by=by)
            results["fused_ffn"].append(row)
            log(f"fused_ffn {name} M {m} d {d}: max_abs {max_abs:.3e} (tol "
                f"{tol_abs:g}) rel_l2 {rel:.3e} (tol {tol_rel:g}) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain {plain:.4f} "
                f"bound {bms:.4f} ({by})")
    phase_int8_kernels(results, randn)
    summary = ", ".join(
        f"{k} {'pass' if all(r['ok'] for r in rows) else 'FAIL'} "
        f"({sum(r['ok'] for r in rows)}/{len(rows)} checks)"
        for k, rows in results.items()
    )
    log(f"kernels: {summary}")
    for k, rows in results.items():
        check(all(r["ok"] for r in rows), f"{k} disagrees with its plain version")
    return results


def phase_int8_kernels(results, randn):
    """The serving path's kernels: GN+SiLU+quantize, the s8 3x3 conv and
    int8-P.V flash attention, each against its plain version on the card."""
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops import quant_conv as qc
    from ldm_tf2_tpu_torch.ops.flash_attention import (
        _plain_pv_int8, flash_attention_pv_int8,
    )
    from ldm_tf2_tpu_torch.ops.fused_conv import gn_silu_conv3x3

    chains = SERVE_CHAINS
    for shape, cout, epilogue in chains:
        check(qc.use_int8_conv(shape, cout, 32, epilogue == "residual"),
              f"the int8 gate declines {shape} -> {cout}")
    # stage 1 at every serving input shape, plus a map the TPU streams
    gn_shapes = sorted({shape for shape, _, _ in chains}) + [(8, 64, 64, 320)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for shape in gn_shapes if dtype == torch.bfloat16 else gn_shapes[:1]:
            c = shape[-1]
            x = (randn(*shape) * 2 + 0.5).to(dtype)
            gamma, beta = randn(c, scale=0.5) + 1.0, randn(c, scale=0.5)
            y8, sa = qc.gn_silu_quant(x, gamma, beta)
            r8, rsa = qc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5)
            torch.cuda.synchronize()
            sa_rel = float(((sa - rsa).abs() / rsa).max())
            diff = (y8.int() - r8.int()).abs()
            codes_max, flipped = int(diff.max()), float((diff > 0).float().mean())
            ok = sa_rel <= 1e-6 and codes_max <= 1 and flipped <= 1e-3
            ms = time_ms(lambda: qc.gn_silu_quant(x, gamma, beta))
            plain = time_ms(lambda: qc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5))
            n = x.numel()
            # x read, codes written; ~14 float32 operations an element
            bms, by = bound_ms(n * (x.element_size() + 1), 14.0 * n, "float32")
            results["gn_silu_quant"].append(dict(
                shape=list(shape), dtype=name, max_abs_err=float(codes_max), ok=ok,
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by))
            log(f"gn_silu_quant {name} {list(shape)}: sa rel {sa_rel:.2e} (tol 1e-6), "
                f"codes max diff {codes_max} (tol 1) on {flipped:.2e} of them (tol 1e-3) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain {plain:.4f} "
                f"bound {bms:.4f} ({by})")

    gen = torch.Generator(device="cuda").manual_seed(99)
    for shape, cout, epilogue in chains:
        b, h, w, cin = shape
        y8 = torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
        w8 = torch.randint(-127, 128, (cout, 3, 3, cin), generator=gen,
                           device="cuda").to(torch.int8)
        sa, ws = randn(b).abs() * 0.01 + 1e-3, randn(cout).abs() * 0.01 + 1e-3
        bias = randn(cout)
        extra = ({"time_add": randn(b, cout).bfloat16()} if epilogue == "t" else
                 {"residual_add": randn(b, h, w, cout).bfloat16()})
        args = (y8, sa, w8, ws, bias)
        got = qc.s8_conv3x3(*args, out_dtype=torch.bfloat16, **extra)
        want = qc._plain_s8_conv3x3(*args, extra.get("time_add"),
                                    extra.get("residual_add"), torch.bfloat16)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max())
        ms = time_ms(lambda: qc.s8_conv3x3(*args, out_dtype=torch.bfloat16, **extra))
        plain = time_ms(lambda: qc._plain_s8_conv3x3(
            *args, extra.get("time_add"), extra.get("residual_add"), torch.bfloat16),
            iters=3, warmup=1)
        y32, w32 = y8.permute(0, 3, 1, 2).float(), w8.permute(0, 3, 1, 2).float()
        lib = time_ms(lambda: F.conv2d(y32, w32, padding=1))
        # the bf16 chain that the int8 mode replaces, on bf16 activations
        x = randn(*shape).bfloat16()
        wb = randn(cout, cin, 3, 3, scale=cin**-0.5).bfloat16()
        gamma, beta = randn(cin) + 1.0, randn(cin)
        chain = time_ms(lambda: gn_silu_conv3x3(x, gamma, beta, wb, bias, **extra))
        m = b * h * w
        nbytes = m * cin + 9 * cin * cout + 2 * m * cout + (
            2 * m * cout if epilogue == "residual" else 2 * b * cout)
        bms, by = bound_ms(nbytes, 2.0 * m * cout * 9 * cin, "int8")
        results["s8_conv3x3"].append(dict(
            shape=[*shape, cout], epilogue=epilogue, dtype="bfloat16", max_abs_err=err,
            ok=ok, ms=ms, plain_ms=plain, library_ms=lib, bf16_chain_ms=chain,
            bound_ms=bms, bound_by=by))
        log(f"s8_conv3x3 {list(shape)} -> {cout} +{epilogue}: equal to the plain "
            f"version {'PASS' if ok else 'FAIL'} (max abs {err:.1e}); ms {ms:.4f} "
            f"plain {plain:.4f} cudnn-f32 {lib:.4f} bf16 chain {chain:.4f} "
            f"bound {bms:.4f} ({by})")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, t, h, s in ((8, 1024, 8, 40), (4, 1024, 1, 512)):
            q, k, v = (randn(b, t, h, s).to(dtype) for _ in range(3))
            scale = s**-0.5
            got = flash_attention_pv_int8(q, k, v, scale)
            ref = _plain_pv_int8(q.float(), k.float(), v.float(), scale)
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = PV_TOL[name]
            ok = max_abs <= tol_abs and rel <= tol_rel
            ms = time_ms(lambda: flash_attention_pv_int8(q, k, v, scale))
            plain = time_ms(lambda: _plain_pv_int8(q, k, v, scale), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
            flops = 2.0 * b * h * t * t * s
            qk_type = "bfloat16" if dtype == torch.bfloat16 else "float32"
            t_ops = flops / PEAK_OPS[qk_type] + flops / PEAK_OPS["int8"]
            t_bytes = 4 * q.numel() * q.element_size() / PEAK_BYTES
            bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                                 else "bytes")
            results["flash_attention_pv_int8"].append(dict(
                shape=[b, t, t, h, s], dtype=name, max_abs_err=max_abs, rel_l2=rel,
                ok=ok, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by))
            log(f"flash_attention_pv_int8 {name} q[{b},{t},{h},{s}]: max_abs "
                f"{max_abs:.3e} (tol {tol_abs:g}) rel_l2 {rel:.3e} (tol {tol_rel:g}) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain {plain:.4f} sdpa "
                f"{lib:.4f} bound {bms:.4f} ({by})")


def phase_unet():
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = validate({**NORTH_STAR, "tpu": {"compute_dtype": "float32"}})
    unet = factory.randomize_(factory.build_unet(config, "cuda"), seed=11)
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(4, 32, 32, 4, generator=gen)
    t = torch.tensor([981.0, 981.0, 501.0, 21.0])
    ctx = torch.randn(4, 77, 1280, generator=gen)
    cpu = factory.build_unet(config, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in unet.state_dict().items()})
    with torch.inference_mode():
        start = time.perf_counter()
        ref = cpu(x, t, ctx)
        cpu_s = time.perf_counter() - start
        cpu.set_serving_modes(conv_quant=True, attention_pv_int8=True)
        start = time.perf_counter()
        ref8 = cpu(x, t, ctx)
        cpu8_s = time.perf_counter() - start
        del cpu
        out = {"float32": unet(x.cuda(), t.cuda(), ctx.cuda())}
        unet.set_serving_modes(conv_quant=True, attention_pv_int8=True)
        out8 = unet(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        unet.set_serving_modes()
        unet = unet.to(torch.bfloat16)
        unet.dtype = torch.bfloat16
        out["bfloat16"] = unet(x.cuda(), t.cuda(), ctx.cuda())
        torch.cuda.synchronize()
    del unet
    torch.cuda.empty_cache()
    for name, y in out.items():
        y = y.float().cpu()
        check(bool(torch.isfinite(y).all()), f"U-Net {name} output not finite")
        _, rel = errors(y, ref)
        ok = rel < UNET_TOL[name]
        log(f"unet full width, card {name} vs CPU float32 (plain path, "
            f"{cpu_s:.1f} s): rel_l2 {rel:.3e} (bound {UNET_TOL[name]:g}) "
            f"{'PASS' if ok else 'FAIL'}")
        check(ok, f"full-width U-Net {name} card vs CPU rel_l2 {rel:.3e}")
    check(bool(torch.isfinite(out8).all()), "U-Net int8 output not finite")
    _, rel = errors(out8, ref8)
    _, effect = errors(ref8, ref)
    ok = rel < UNET_TOL["int8 float32"]
    log(f"unet full width, int8 + int8-P.V float32, card vs CPU (plain path, "
        f"{cpu8_s:.1f} s): rel_l2 {rel:.3e} (bound {UNET_TOL['int8 float32']:g}) "
        f"{'PASS' if ok else 'FAIL'}; the int8 modes move the CPU output by "
        f"rel_l2 {effect:.3e}")
    check(ok and rel < effect / 2,
          f"full-width U-Net int8 card vs CPU rel_l2 {rel:.3e}, int8 effect {effect:.3e}")


def phase_main_path(card: str):
    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img, tensor_to_image
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
    from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    config = validate(json.loads(json.dumps(NORTH_STAR)))
    sampling = config["ldm_sampling"]
    start = time.perf_counter()
    models = [
        factory.randomize_(build(config, device="cuda"), seed)
        for seed, build in ((21, factory.build_cond_model),
                            (22, factory.build_unet),
                            (23, factory.build_autoencoder))
    ]
    n_params = sum(p.numel() for m in models for p in m.parameters())
    torch.cuda.synchronize()
    log(f"main path: built {n_params / 1e9:.3f} B params (bf16) in "
        f"{time.perf_counter() - start:.1f} s")
    tokenizer = load_tokenizer(os.path.join(ROOT, sampling["vocab_dir"]))
    shape = tuple(sampling["latent_shape"])
    ids = torch.as_tensor(cfg_token_ids(tokenizer, sampling["text_prompt"],
                                        shape[0], 77))
    kwargs = dict(guidance_scale=sampling["guidance_scale"],
                  scale_factor=config["ldm"]["scale_factor"], seed=0,
                  device="cuda")
    # warm-up: a 2-step run outside the counted, timed one
    sample_txt2img(*models, make_schedule(num_ddim_steps=2), ids, shape, **kwargs)
    schedule = factory.build_schedule(config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    fused_ffn.launches = 0
    start = time.perf_counter()
    images, _ = sample_txt2img(*models, schedule, ids, shape, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {"flash_attention": flash_attention.launches,
                "fused_ffn": fused_ffn.launches}

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    images = images.float().cpu().numpy()
    check(bool(np.isfinite(images).all()), "images are not finite")
    pixels = tensor_to_image(images)
    check(pixels.shape == (2, 256, 256, 3) and pixels.dtype == np.uint8,
          f"images {pixels.shape} {pixels.dtype}")
    steps = schedule.num_ddim_steps
    log(f"main path on {card}: {steps} steps, batch {shape[0]}, 256^2: "
        f"{seconds:.3f} s total, {seconds / steps * 1e3:.2f} ms per DDIM step "
        f"(encode and decode included), {shape[0] / seconds:.3f} img/s, peak "
        f"memory {peak_gb:.2f} GB; launches {launches}")
    want = {"flash_attention": 16 * steps + 1, "fused_ffn": 16 * steps}
    check(launches == want, f"launch counts {launches}, expected {want}")
    phase_profile(models[1], shape)
    return launches, models


def phase_serve(card: str, models):
    """The JSONL server in the int8 serving modes at the north-star widths,
    driven through ``serve()`` with an in-memory stream: two requests of
    seed 1 that pack into one batch-4 call, one of seed 2 (a padded call),
    one malformed line.  Counts are read around the whole run: the warm-up
    call and the two request calls."""
    import io
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.ops import flash_attention as fa
    from ldm_tf2_tpu_torch.ops import quant_conv as qc
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    config = json.loads(json.dumps(NORTH_STAR))
    config["ldm_sampling"].update(
        latent_shape=[4, 32, 32, 4], vocab_dir=os.path.join(ROOT, "bert_model"))
    config["tpu"].update(quantize="int8", quantize_attention="int8pv")
    config = validate(config)
    steps = config["ldm"]["num_ddim_steps"]

    # what one pipeline call launches: SERVE_EVAL per U-Net eval, and the
    # decoder's mid-block attention (1024 tokens) in int8 P.V
    ev = SERVE_EVAL
    per_call = {"gn_silu_quant": steps * ev["int8_chains"],
                "s8_conv3x3": steps * ev["int8_chains"],
                "flash_attention_pv_int8": steps * ev["pv_int8"] + 1,
                "flash_attention": steps * (ev["self_attentions"] - ev["pv_int8"]),
                "fused_ffn": steps * ev["ffn"]}
    calls = 3  # warm-up, seed 1 (4 slots), seed 2 (1 slot, 3 padded)
    want = {k: calls * v for k, v in per_call.items()}

    requests = "\n".join([
        json.dumps({"prompt": "a virus monster is playing guitar", "n": 2,
                    "seed": 1, "guidance_scale": 5.0, "out": "s1"}),
        json.dumps({"prompt": ["an oil painting of a harbour", "a red fox"],
                    "seed": 1, "guidance_scale": 7.5, "out": "s2"}),
        json.dumps({"prompt": "a lighthouse at dusk", "n": 1, "seed": 2,
                    "out": "s3"}),
        "this is not json",
    ])
    counters = {"flash_attention": fa.flash_attention, "fused_ffn": fused_ffn,
                "gn_silu_quant": qc.gn_silu_quant, "s8_conv3x3": qc.s8_conv3x3,
                "flash_attention_pv_int8": fa.flash_attention_pv_int8}
    out = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        start = time.perf_counter()
        serve_ldm.serve(config, io.StringIO(requests), out, output_dir=out_dir,
                        device="cuda", models=models)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: fn.launches for k, fn in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        resps = [json.loads(line) for line in out.getvalue().splitlines()]
        check(len(resps) == 4, f"{len(resps)} responses, expected 4")
        check([r["ok"] for r in resps] == [True, True, True, False]
              and "error" in resps[3], f"responses {resps}")
        for r, n in zip(resps[:3], (2, 2, 1)):
            images = np.load(r["out"])
            check(images.shape == (n, 256, 256, 3) and images.dtype == np.uint8,
                  f"{r['out']}: {images.shape} {images.dtype}")
            check(int(images.max()) > int(images.min()), f"{r['out']} is flat")
    wave_s = resps[0]["latency_s"]
    log(f"serve on {card}: int8 + int8-P.V, 50 steps, batch 4, 256^2: warm-up "
        f"call and model setup {seconds - wave_s:.3f} s, one wave of 3 requests "
        f"(5 images) in 2 calls {wave_s:.3f} s = {wave_s / 2:.3f} s per call, "
        f"{5 / wave_s:.3f} requested img/s ({8 / wave_s:.3f} slot img/s), peak "
        f"memory {peak_gb:.2f} GB; launches over {calls} calls {launches}")
    check(launches == want, f"serve launch counts {launches}, expected {want}")
    phase_profile(models[1], (4, 32, 32, 4))  # the U-Net in its int8 modes
    return launches


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention kernel"
    if "pv_int8" in low or "v_scale" in low:
        return "flash_attention_pv_int8 kernels"
    if "s8_conv" in low:
        return "s8_conv3x3 kernel"
    if any(k in low for k in ("gn_stats", "gn_amax", "gn_quant")):
        return "gn_silu_quant kernels"
    if "ffn_" in low:
        return "fused_ffn kernels"
    if "fprop" in low or "conv" in low or "dgrad" in low:
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS)"
    return "elementwise / norm / copy"


def phase_profile(unet, shape, evals: int = 3):
    """Device time by kernel group over a few U-Net evals at the CFG batch
    of a latent ``shape``, and the device's idle share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    b2 = 2 * shape[0]
    x = torch.randn((b2, *shape[1:]), generator=gen, device="cuda",
                    dtype=unet.dtype)
    t = torch.full((b2,), 501.0, device="cuda")
    ctx = torch.randn(b2, 77, 1280, generator=gen, device="cuda",
                      dtype=unet.dtype) * 0.05
    with torch.inference_mode():
        unet(x, t, ctx)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(evals):
            unet(x, t, ctx)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(evals):
                unet(x, t, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    groups: dict[str, float] = {}
    kernels: dict[str, tuple[float, int]] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            key = _kernel_group(evt.key)
            groups[key] = groups.get(key, 0.0) + dev_us / 1e3
            kernels[evt.key] = (dev_us / 1e3, evt.count)
    busy = sum(groups.values())
    if busy <= 0.0:
        log("profile: the profiler recorded no device time")
        return
    parts = ", ".join(f"{k} {v / evals:.2f} ms ({v / busy:.1%})"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    launches = sum(n for _, n in kernels.values()) / evals
    modes = "int8 + int8-P.V" if unet.conv_quant else "bf16"
    log(f"profile: {modes} U-Net eval at CFG batch {b2}, {evals} evals: "
        f"{bare_ms / evals:.2f} ms wall per eval without the profiler, "
        f"{wall_ms / evals:.2f} ms with it; device busy {busy / evals:.2f} ms "
        f"in {launches:.0f} kernel launches, idle share "
        f"{1 - busy / bare_ms:.1%} of the unprofiled wall "
        f"({1 - busy / wall_ms:.1%} profiled); by group: {parts}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("profile: top kernels per eval: " + "; ".join(
        f"{name[:60]} {ms / evals:.3f} ms x{n // evals}" for name, (ms, n) in top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.ops import _build

    factory.set_float32_precision()
    seconds = _build.build(KERNELS)
    log("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    results = phase_kernels()
    phase_unet()
    launches, models = phase_main_path(card)
    # the serving path's kernels report their launches in the serve run
    launches.update({k: v for k, v in phase_serve(card, models).items()
                     if k not in launches})

    replaces = {"flash_attention": "ldm_tf2_tpu/ops/flash_attention.py:147",
                "fused_ffn": "ldm_tf2_tpu/ops/fused_ffn.py:132",
                "gn_silu_quant": "ldm_tf2_tpu/ops/quant_conv.py:104",
                "s8_conv3x3": "ldm_tf2_tpu/ops/quant_conv.py:722",
                "flash_attention_pv_int8": "ldm_tf2_tpu/ops/flash_attention.py:186"}
    kernels = []
    for name, rows in results.items():
        main_row = rows[0]  # bf16 at the path's first (level-0) shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ldm_tf2_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
