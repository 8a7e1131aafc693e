"""Device times of the port's bf16 FFN (row 2, ``fused_ffn``) at
``chip_smoke.FFN_SHAPES``, its W8A8 FFN (row 4, ``fused_ffn_int8``) at
``chip_smoke.FFN8_SHAPES`` beside row 2 at the same shapes, its s8 3x3
conv (row 11, ``s8_conv3x3``) at ``chip_smoke.SERVE_CHAINS``, its
GN+SiLU+quantize (rows 8 and 9,
``gn_silu_quant``) at the distinct ``SERVE_CHAINS`` inputs and the map the
TPU streams, its fused GroupNorm (row 5, ``group_norm_fused``) at
``chip_smoke.OPT_GN``: per call and per kernel launched, from
``torch.profiler`` through ``chip_smoke.device_ms``, on random inputs made
from a seed; and its bf16 flash forward (row 1, ``flash_attention``) at the
decoder's mid-block attention of a batch-4 serving call, ``DECODER_ATTENTION``,
beside SDPA, wall (``chip_smoke.time_ms``) and device time, with its bound.
Needs a CUDA card.  Run from the root of a checkout:

    python3 kernel_times.py [ffn] [ffn8] [s8conv] [gnq] [gn] [flash] [--rounds N]

It prints one JSON line per shape and round, then the card's name and power
limit.  To compare two trees on one card, copy this script into the root of
the other and run the two in turn on one card (A, B, B, A): each imports
the ``chip_smoke`` and ``ldm_tf2_tpu_torch`` beside it."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def ffn_times(gen):
    import torch

    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for m, d in chip_smoke.FFN_SHAPES:
        f = 4 * d
        x = randn(1, m, d).bfloat16()
        lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
        ws = [randn(d, f, scale=d**-0.5), randn(f, scale=0.1), randn(d, f, scale=d**-0.5),
              randn(f, scale=0.1), randn(f, d, scale=f**-0.5), randn(d, scale=0.1)]
        ws = [w.bfloat16() for w in ws]
        parts = {}
        ms = chip_smoke.device_ms(lambda: fused_ffn(x, lns, lnb, *ws), by_kernel=parts)
        yield dict(kernel="fused_ffn", shape=[m, d], device_ms=ms, parts=parts)


def ffn8_times(gen):
    import torch

    from ldm_tf2_tpu_torch.ops import fused_ffn as ff

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for m, d in chip_smoke.FFN8_SHAPES:
        f = 4 * d
        x = randn(1, m, d).bfloat16()
        lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
        w1v, w1g = (randn(d, f, scale=d**-0.5).bfloat16() for _ in range(2))
        w2 = randn(f, d, scale=f**-0.5).bfloat16()
        b1v, b1g, b2 = (randn(n, scale=0.1).bfloat16() for n in (f, f, d))
        q = ff.quantize_ffn_weights(w1v, w1g, w2)
        per_call = []
        ms = chip_smoke.device_ms(lambda: ff.fused_ffn_int8(x, lns, lnb, q, b1v, b1g, b2),
                                  launches=per_call)
        bf16 = chip_smoke.device_ms(lambda: ff.fused_ffn(x, lns, lnb, w1v, b1v, w1g, b1g, w2,
                                                         b2))
        yield dict(kernel="fused_ffn_int8", shape=[m, d], device_ms=ms, launches=per_call[0],
                   bf16_ffn_device_ms=bf16)


def s8conv_times(gen):
    import torch

    from ldm_tf2_tpu_torch.ops.quant_conv import s8_conv3x3

    for shape, cout, epilogue in chip_smoke.SERVE_CHAINS:
        b, h, w, cin = shape
        y8 = torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
        w8 = torch.randint(-127, 128, (cout, 3, 3, cin), generator=gen,
                           device="cuda").to(torch.int8)
        sa = torch.rand(b, generator=gen, device="cuda") * 0.01 + 1e-3
        ws = torch.rand(cout, generator=gen, device="cuda") * 0.01 + 1e-3
        bias = torch.randn(cout, generator=gen, device="cuda")
        extra = ({"time_add": torch.randn(b, cout, generator=gen, device="cuda").bfloat16()}
                 if epilogue == "t" else
                 {"residual_add": torch.randn(b, h, w, cout, generator=gen,
                                              device="cuda").bfloat16()})
        parts = {}
        ms = chip_smoke.device_ms(
            lambda: s8_conv3x3(y8, sa, w8, ws, bias, out_dtype=torch.bfloat16, **extra),
            by_kernel=parts)
        yield dict(kernel="s8_conv3x3", shape=list(shape), cout=cout, device_ms=ms,
                   parts=parts)


def gnq_times(gen):
    import torch

    from ldm_tf2_tpu_torch.ops.quant_conv import gn_silu_quant

    shapes = sorted({shape for shape, _, _ in chip_smoke.SERVE_CHAINS}) + [(8, 64, 64, 320)]
    for shape in shapes:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
        beta = torch.randn(c, generator=gen, device="cuda") * 0.5
        per_call = []
        ms = chip_smoke.device_ms(lambda: gn_silu_quant(x, gamma, beta), launches=per_call)
        yield dict(kernel="gn_silu_quant", shape=list(shape), device_ms=ms,
                   launches=per_call[0])


def gn_times(gen):
    import torch

    from ldm_tf2_tpu_torch.ops.group_norm import group_norm_fused

    for shape, eps, act in chip_smoke.OPT_GN:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
        beta = torch.randn(c, generator=gen, device="cuda") * 0.5
        per_call = []
        ms = chip_smoke.device_ms(lambda: group_norm_fused(x, gamma, beta, 32, eps, act),
                                  launches=per_call)
        yield dict(kernel="group_norm_fused", shape=list(shape), silu=act, device_ms=ms,
                   launches=per_call[0])


# (B, T, H, S) of the autoencoder's mid-block attention when a batch-4
# serving call decodes at 256^2
DECODER_ATTENTION = (4, 1024, 1, 512)


def flash_times(gen):
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention

    b, t, h, s = DECODER_ATTENTION
    q, k, v = (torch.randn(b, t, h, s, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    scale = s**-0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: flash_attention(q, k, v, scale)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    err = float((kernel().float() - sdpa().transpose(1, 2).float()).abs().max())
    ops = 2 * 2.0 * b * h * t * t * s  # q k^T and p v
    t_ops = ops / chip_smoke.PEAK_OPS["bfloat16"]
    t_bytes = 4 * q.numel() * q.element_size() / chip_smoke.PEAK_BYTES
    yield dict(kernel="flash_attention", shape=[b, t, h, s], dtype="bfloat16",
               ms=chip_smoke.time_ms(kernel), device_ms=chip_smoke.device_ms(kernel),
               library_ms=chip_smoke.time_ms(sdpa),
               library_device_ms=chip_smoke.device_ms(sdpa), bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_against_sdpa=err)


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kinds = ("ffn", "ffn8", "s8conv", "gnq", "gn", "flash")
    p.add_argument("kernels", nargs="*", choices=kinds, default=list(kinds))
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 1
    times = {"ffn": ffn_times, "ffn8": ffn8_times, "s8conv": s8conv_times, "gnq": gnq_times,
             "gn": gn_times, "flash": flash_times}
    for rnd in range(args.rounds):
        for name in args.kernels:
            for row in times[name](torch.Generator(device="cuda").manual_seed(1234)):
                print(json.dumps(dict(row, round=rnd, tree=os.path.dirname(
                    os.path.abspath(__file__)))), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
