#!/usr/bin/env python3
"""Drive the PyTorch port (ldm_tf2_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the
final line is printed:

1. device: the card's name and power limit (nvidia-smi), CUDA present;
2. build: the ten CUDA sources compiled from ldm_tf2_tpu_torch/csrc with
   nvcc, one process each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with its time, the plain version's time,
   the card's bound and, where one PyTorch call computes a comparable
   function, that call's time as a yardstick (attention: SDPA, and the
   backward of SDPA through autograd for the flash backward; the s8
   conv: cuDNN's float32 conv of the same codes, and the bf16 GN -> SiLU
   -> conv chain that int8 replaces; the opt-in kernels: F.group_norm,
   torch.var_mean, the default bf16 chain and SDPA), the opt-in kernels
   at every shape of the opt-in main path (``OPT_GN``, ``OPT_CHAINS``,
   ``OPT_CROSS``) in both dtypes; each flash launch's path (wgmma,
   mma.sync or FMA, from the wrappers' ``launches_by_path``; the int8-P.V
   forward's too): every bf16 launch at the models' head dims (40, 80,
   160, 512) takes wgmma; each fused chain and cross-attention launch's
   path too (wgmma in bf16, FMA in float32), and the chain's device time
   summed over one U-Net eval's 44 chains (``OPT_EVAL_CHAINS``) against the
   default chain's and the bound; the fused FFN at every ``FFN_SHAPES``
   shape and the s8 conv at every ``SERVE_CHAINS`` shape with each launch's
   path (wgmma in bf16, FMA for the float32 FFN), two FFN calls held
   bit-equal, the FFN's library yardstick (the unfused chain of PyTorch
   calls), and their device times summed over one U-Net eval's 16 FFNs
   (``FFN_EVAL``, at CFG batch 4 and 8) and 29 int8 convs
   (``SERVE_EVAL_CHAINS``) against the bound; the GN+SiLU+quantize (rows 8
   and 9) at every ``SERVE_CHAINS`` input and the map the TPU streams, and
   the fused GroupNorm (row 5) at every ``OPT_GN`` shape, each held to one
   launch a call (the profiler's count), to its cluster plan's mode
   (resident in shared memory at every serving shape, re-read at
   ``STREAMED_MAP`` and ``OPT_GN_REREAD``) and to two calls bit-equal,
   row 8's device time summed over one serve eval's 29 calls and row 5's
   over one opt-in eval's 17 (counted by shape in that eval); beside each
   timed row's wall time, its device time per call from ``torch.profiler``
   (``device_ms``, and the library call's ``library_device_ms``);
4. unet: one full-width U-Net eval (CFG batch 4, 32x32 latent, seeded
   weights) on the card against the same weights on the CPU in float32,
   plain, under ``tpu.attention_impl: xla`` (no flash launch) and in the
   int8 serving modes;
5. main path: 50-step CFG DDIM txt2img at the north-star config (batch 2,
   256^2, seeded full-width weights, bf16), through ``sample_txt2img``,
   with the kernels' launch counts read around that one run; then a
   torch.profiler window over a few U-Net evals (device time by kernel
   group, idle share);
5b. opt-in main path: the same call with the JAX package's three opt-in
   switches on (GroupNorm, fused conv, packed cross), in turns with the
   default route, exact launch counts (``OPT_EVAL``, ``OPT_DECODE``),
   every chain and cross-attention launch on wgmma, every GroupNorm launch
   resident but the decoder's last (re-read), each chain weight
   relaid for the wgmma conv once (72 in the first call, none after),
   latents and images against the default route's, a profiled window with
   its device busy time beside the default route's; a 10-step run with
   GroupNorm "stats";
5c. samplers, switches on: PLMS, DPM-Solver++(2M) (karras), DDPM on a
   100-step timeline, the progressive DDIM loop, one ``serve()`` call with
   dpm_solver_pp_2m;
5d. DeepCache, img2img and inpainting, switches off: the full-width
   U-Net's shallow pass fed a fresh cache against its full pass
   (``DEEPCACHE_TOL``, bit-equality printed) and a profiled shallow eval;
   DDIM DeepCache (50 steps, interval 3) and plain DDIM in turns, interval
   1 against the main path's images; DPM-Solver++(2M) DeepCache (20 karras
   steps, interval 2, two levels); ``sample_img2img`` at strength 0.75 and
   with a mask (the kept latent exactly the init latent); a DeepCache
   ``serve()`` request; a DeepCache call in the int8 serving modes at
   batch 4; each call's launches held to ``eval_counts``;
5e. convert, export, eval (``phase_convert_export_eval``): a CompVis
   checkpoint with every key of ``tests/goldens/compvis_key_manifest.json``
   (1,498,849,707 seeded model parameters) saved with ``torch.save``, the
   converter CLI's ``--validate_only`` and its conversion from the file
   into one blob (``convert_checkpoint``), the sampler CLI on that blob (50
   CFG DDIM steps, launches counted: flash 801, FFN 800, every bf16 launch
   on wgmma; images bit-equal to the trees that conversion returned,
   loaded in memory), ``export_pretrained --which serving
   --dtype bfloat16`` and the sampler on the bf16 blob (bit-equal to the
   float32 blob under ``tpu.weights_dtype: bfloat16``), each blob's size
   and read time, then ``run_eval.evaluate``'s VGG-FID against a second
   seeded batch, the VGG and synthetic-weight Inception pool3 features
   card vs CPU (``FEATURES_TOL``) and each extractor's img/s;
6. serve: the JSONL server (``cli/serve_ldm.serve``) in the int8 serving
   modes (``tpu.quantize: int8``, ``quantize_attention: int8pv``) at the
   north-star widths, batch 4, 50 steps, on four requests from an
   in-memory stream, with the launch counts read around it and held to
   what the north-star U-Net dispatches (``SERVE_EVAL``), every int8-P.V
   launch on wgmma, every GN+SiLU+quantize launch resident;
7. train: the stage-2 trainer (``cli/run_ldm_trainer.train``) at the
   north-star widths, batch 8, 256^2, bf16 compute over float32 U-Net
   masters, frozen text encoder and autoencoder in bf16, U-Net and
   condition dropout 0.1, EMA on, in-memory batches: 2 warm-up steps, then
   5 timed steps with the launch counts read around them (``TRAIN_STEP``),
   then 2 steps under the profiler; then (7b) one step under each remat
   policy (``tpu.remat`` false, true, full, blocks, dots) from the same
   state, the loss equal to the plain step's, the update and the gradient
   within ``GRAD_TOL`` per group, each policy's peak memory and s/step
   (``phase_remat``); the indexed loader's resume through ``train`` with
   ``deterministic_data`` (``phase_resume``: 4 steps unbroken against 2 +
   2 resumed from a checkpoint, the batches bit-equal); and the
   data-parallel code at world 1 in an NCCL group of one process, the LDM
   step, the AE GAN step and a CFG sampler call each bit-equal to the
   plain run, then two ranks against one process when the machine has two
   cards (``phase_data_parallel``).  Before it, the kernels phase checks
   the flash backward kernels at the training path's shapes, and a gradient
   phase holds a north-star-width U-Net's parameter gradients on the card
   to the CPU's in float32, with the opt-in switches off and on;
8. AE train: the stage-1 trainer (``cli/run_autoencoder_trainer.train``)
   on the repo config's VQ autoencoder at full width (channels 128,
   multipliers [1, 2, 2, 4], attention at 32^2, codebook 16384 x 4), its
   PatchGAN and a seeded LPIPS VGG16, batch 3, 256^2, bf16 compute, GAN
   from step 1: 2 warm-up steps, 5 timed with the flash launch counts read
   around them (``AE_STEP_ATTENTIONS``), 1 profiled GAN step; then 3 steps
   of the KL autoencoder with its discriminator, through both phases.
   Before it an AE gradient phase holds the phase-2 gradients of a
   full-width VQ autoencoder (64^2, attention at 8^2, S = 512), its
   discriminator's gradients and running statistics, card vs CPU in
   float32.  The kernels phase also checks row 4, the W8A8 FFN that no path
   dispatches (``FFN8_SHAPES``), and the whole int8 chain (row 10).

The main path, opt-in, DeepCache / img2img, serve, LDM train and AE
train phases also check that no bf16 launch of theirs took the FMA path
and that every FFN and s8 conv launch took wgmma.  The last lines are the
kernels JSON, the nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
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
SOURCES = ("flash_attention", "fused_ffn", "gn_silu_quant", "s8_conv3x3",
           "flash_attention_pv_int8", "flash_attention_bwd", "group_norm",
           "gn_silu_conv3x3", "cross_attention", "fused_ffn_int8")
# One entry per TPU kernel of the JAX package (13 rows of PERF.md's table):
# rows 9 (the streamed GN+SiLU+quantize) and 10 (the whole int8 chain) are
# carried by the kernels of rows 8 and 11 and measured at their own shapes.
KERNELS = ("flash_attention", "fused_ffn", "gn_silu_quant", "s8_conv3x3",
           "flash_attention_pv_int8", "flash_backward_dq", "flash_backward_dkv",
           "group_norm_fused", "group_stats", "gn_silu_conv3x3_fused",
           "cross_attention", "fused_ffn_int8", "gn_silu_quant_stream",
           "int8_chain")

# (B, Tq, Tk, H, S): the main path's self-attentions (CFG batch 4), then
# the serve path's bf16 ones (CFG batch 8; its level-0 ones take int8 P.V)
ATTN_SHAPES = [
    (4, 1024, 1024, 8, 40), (4, 256, 256, 8, 80), (4, 64, 64, 8, 160),
    (4, 16, 16, 8, 160), (2, 1024, 1024, 1, 512), (4, 1000, 1000, 8, 40),
    (8, 256, 256, 8, 80), (8, 64, 64, 8, 160), (8, 16, 16, 8, 160),
    (3, 1024, 1024, 1, 512), (8, 1024, 1024, 1, 512), (2, 1024, 1000, 1, 512),
]
# the autoencoder's S = 512 above: the sampling decode (batch 2), the VQ AE
# train step (batch 3), the LDM train step's encode (batch 8), a ragged kv.
# Every bf16 launch at the models' head dims takes the wgmma path (read
# from the wrappers' launches_by_path); float32 the FMA path.
WGMMA_HEAD_DIMS = (40, 80, 160, 512)
# (M, d): the main path's FFNs (CFG batch 4), then the serve path's (batch 8)
FFN_SHAPES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280),
              (8192, 320), (2048, 640), (512, 1280), (128, 1280)]
# ([B, H, W, Cin], Cout, epilogue): the distinct ResBlock chains of the
# north-star U-Net that the int8 gate quantizes at the serve path's CFG
# batch 8 (tests/test_torch_int8.py holds the gate to the JAX package's on
# every chain), and what one U-Net eval there dispatches: 29 int8 chains,
# 19 of them at the shapes where the JAX package runs its whole-chain
# kernel (row 10; the other 10, at 8x8, run rows 8 and 11 there too), 16
# spatial self-attentions of which the 5 at level 0 (1024 tokens) take
# int8 P.V, 16 FFNs.  The autoencoder's decode adds one int8-P.V attention.
# No map at 256^2 is beyond the TPU's one-pass GN+SiLU+quantize slab, so
# row 9's count (the streamed kernel) is 0 on this path.
SERVE_CHAINS = [
    ((8, 32, 32, 320), 320, "t"), ((8, 32, 32, 320), 320, "residual"),
    ((8, 16, 16, 320), 640, "t"), ((8, 16, 16, 640), 640, "residual"),
    ((8, 16, 16, 640), 640, "t"), ((8, 8, 8, 640), 1280, "t"),
    ((8, 8, 8, 1280), 1280, "residual"), ((8, 8, 8, 1280), 1280, "t"),
    ((8, 8, 8, 2560), 1280, "t"), ((8, 8, 8, 1920), 1280, "t"),
    ((8, 16, 16, 1920), 640, "t"), ((8, 16, 16, 1280), 640, "t"),
    ((8, 16, 16, 960), 640, "t"), ((8, 32, 32, 640), 320, "t"),
]
SERVE_EVAL = {"int8_chains": 29, "whole_chains": 19, "self_attentions": 16,
              "pv_int8": 5, "ffn": 16}
# How many of one serve eval's 29 int8 chains run at each of SERVE_CHAINS,
# and of one bf16 eval's 16 FFNs at each of FFN_SHAPES' first four (CFG batch
# 4; the serve eval's at CFG 8 are the last four): the weights of rows 11's
# and 2's per-eval sums of device times
SERVE_EVAL_CHAINS = [2, 5, 1, 5, 1, 1, 5, 1, 2, 1, 1, 1, 1, 2]
# Row 9's map: beyond the TPU's one-pass VMEM slab (it streams there) and
# beyond a cluster of 8 CTAs' shared memory (the port re-reads there)
STREAMED_MAP = (8, 64, 64, 320)
FFN_EVAL = [5, 5, 5, 1]

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
# (B, Tq, Tk, H, S, extreme): the training path's self-attentions at batch
# 8, 256^2, then a ragged kv whose logits lie near -160 (an unmasked padded
# key would overflow exp()), then the autoencoder's 512-wide head
BWD_SHAPES = [
    (8, 1024, 1024, 8, 40, False), (8, 256, 256, 8, 80, False),
    (8, 64, 64, 8, 160, False), (8, 16, 16, 8, 160, False),
    (4, 1000, 1000, 8, 40, True), (2, 1024, 1024, 1, 512, False),
    (3, 1024, 1024, 1, 512, False), (8, 1024, 1024, 1, 512, False),
]
# rel-L2 of dq, dk, dv against the plain version on the kernel's own lse and
# di: float32 differs in summation order only; bf16 rounds each output once
# (about 2^-9 relative)
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# Row 4, the W8A8 FFN that no path dispatches: (M, d) of the U-Net's FFNs at
# CFG batch 8 ([8, 1024, 320], [8, 256, 640], [8, 64, 1280]), then an M that
# is not a multiple of 128.  rel-L2 against the plain version on the same
# inputs: the LayerNorm's summation order differs, which flips a code of y
# or u where a value lies within an ulp of a rounding midpoint (0.1-1.6% of
# rows at these shapes), and a flip moves its row by up to about 3e-2; bf16
# also rounds the output's three operations.
FFN8_SHAPES = [(8192, 320), (2048, 640), (512, 1280), (1000, 320)]
FFN8_TOL = {"float32": 1e-3, "bfloat16": 5e-3}  # rel L2; max abs 0.1 both
# At most this share of rows may differ from the plain version by more than
# 1e-3 (a code flip; 0.30-1.17% measured on the H100 at these shapes)
FFN8_FLIP_ROWS = 0.02
# Row 10, the int8 ResBlock chain (rows 8 + 11 back to back) against the
# plain chain: a GN+SiLU+quantize code may flip (at most 1e-3 of them, row 8's
# bound), moving its 3x3 neighbourhood's outputs by one code step
CHAIN8_TOL = 5e-3  # rel L2
# Gradient phase: a north-star-width U-Net (one block per level), card vs
# CPU, float32 with TF32 off: summation order through ~40 layers forward and
# back; rel-L2 of each parameter group's gradients
GRAD_TOL = 1e-3
# What one train step launches at the north star: 16 U-Net self-attention
# forwards (saving lse) plus the autoencoder encoder's mid-block attention,
# 16 dq and 16 dk/dv backward launches, 16 FFN forwards (its backward
# recomputes in PyTorch), no int8 kernel
TRAIN_STEP = {"flash_attention": 17, "flash_backward_dq": 16,
              "flash_backward_dkv": 16, "fused_ffn": 16,
              "flash_attention_pv_int8": 0, "gn_silu_quant": 0, "s8_conv3x3": 0,
              "group_norm_fused": 0, "group_stats": 0, "gn_silu_conv3x3_fused": 0,
              "cross_attention": 0, "fused_ffn_int8": 0, "gn_silu_quant_stream": 0,
              "int8_chain": 0}

# Stage-1 autoencoder training: the repo config's sections
# (ldm_tf2_tpu/configs/all_in_one_config.yaml), copied here so that the
# script reads no file of the JAX package; the VQ model at full width
# (channels 128, multipliers [1, 2, 2, 4], attention at 32^2, codebook
# 16384 x 4), batch 3, 256^2.
AE_CONFIG = {
    "autoencoder_vq": dict(latent_channels=4, channels=128, num_blocks=2,
                           attention_resolutions=[32], dropout_rate=0.0,
                           multipliers=[1, 2, 2, 4], resample_with_conv=True,
                           vocab_size=16384, beta=0.25),
    "ae_vq_discriminator": dict(channels=64, num_layers=2),
    "ae_kl_discriminator": dict(channels=64, num_layers=3),
    "autoencoder_kl_trainer": dict(global_step_discriminator=50001, lpips_weight=1.0,
                                   kl_weight=1e-6, discriminator_weight=0.5,
                                   discriminator_factor=1.0,
                                   discriminator_loss_type="hinge"),
    "autoencoder_vq_trainer": dict(global_step_discriminator=1, codebook_weight=1.0,
                                   lpips_weight=1.0, kl_weight=1.0,
                                   discriminator_weight=0.6, discriminator_factor=1.0,
                                   discriminator_loss_type="hinge"),
    "autoencoder_optimizer": dict(learning_rate=4.5e-6, beta_1=0.5, beta_2=0.9,
                                  epsilon=1e-8),
    "discriminator_optimizer": dict(learning_rate=4.5e-6, beta_1=0.5, beta_2=0.9,
                                    epsilon=1e-8),
}
# What one AE train step launches: every single-head self-attention at 32^2
# (1024 tokens, S = 512) runs forward once (saving lse) and backward once.
# VQ: the encoder's two level-3 blocks, its mid block, the decoder's mid
# block and its three 32^2 blocks; KL: the two mid blocks.
AE_STEP_ATTENTIONS = {"vq": 7, "kl": 2}
# AE gradient phase, card vs CPU in float32 (TF32 off), per parameter group:
# summation order through ~60 layers forward and back and the adaptive
# weight's ratio of two gradient norms
AE_GRAD_TOL = 1e-3

# The opt-in main path (the JAX package's switches set_groupnorm_impl,
# set_fused_conv_impl and set_packed_cross on): every distinct shape it
# gives the four opt-in kernels, the U-Net at CFG batch 4 (32x32 latent)
# and the KL decoder at batch 2, read off the module graph.  GroupNorms
# ([B, H, W, C], eps, SiLU): the spatial transformers' (1e-6) at each
# level, the U-Net head's, the decoder's mid-block attention's and head's.
OPT_GN = [((4, 32, 32, 320), 1e-6, False), ((4, 16, 16, 640), 1e-6, False),
          ((4, 8, 8, 1280), 1e-6, False), ((4, 4, 4, 1280), 1e-6, False),
          ((4, 32, 32, 320), 1e-5, True), ((2, 32, 32, 512), 1e-6, False),
          ((2, 256, 256, 128), 1e-6, True)]
# ResBlock chains ([B, H, W, Cin], Cout, epilogue): the U-Net's 18 distinct
# (44 chains an eval), then the decoder's 10 (28 chains a decode)
OPT_CHAINS = [
    ((4, 32, 32, 320), 320, "t"), ((4, 32, 32, 320), 320, "residual"),
    ((4, 16, 16, 320), 640, "t"), ((4, 16, 16, 640), 640, "residual"),
    ((4, 16, 16, 640), 640, "t"), ((4, 8, 8, 640), 1280, "t"),
    ((4, 8, 8, 1280), 1280, "residual"), ((4, 8, 8, 1280), 1280, "t"),
    ((4, 4, 4, 1280), 1280, "t"), ((4, 4, 4, 1280), 1280, "residual"),
    ((4, 4, 4, 2560), 1280, "t"), ((4, 8, 8, 2560), 1280, "t"),
    ((4, 8, 8, 1920), 1280, "t"), ((4, 16, 16, 1920), 640, "t"),
    ((4, 16, 16, 1280), 640, "t"), ((4, 16, 16, 960), 640, "t"),
    ((4, 32, 32, 960), 320, "t"), ((4, 32, 32, 640), 320, "t"),
    ((2, 32, 32, 512), 512, None), ((2, 32, 32, 512), 512, "residual"),
    ((2, 64, 64, 512), 512, None), ((2, 64, 64, 512), 512, "residual"),
    ((2, 128, 128, 512), 256, None), ((2, 128, 128, 256), 256, None),
    ((2, 128, 128, 256), 256, "residual"), ((2, 256, 256, 256), 128, None),
    ((2, 256, 256, 128), 128, None), ((2, 256, 256, 128), 128, "residual"),
]
# Cross-attentions (B, Tq, Tk, H, S): the 77-token text context per level
OPT_CROSS = [(4, 1024, 77, 8, 40), (4, 256, 77, 8, 80), (4, 64, 77, 8, 160),
             (4, 16, 77, 8, 160)]
# What one U-Net eval launches with the switches on (22 ResBlocks of two
# chains, 16 spatial transformers with a GroupNorm and a cross-attention
# each, the head's GroupNorm), and what one decode adds (14 ResBlocks, the
# mid-block attention's and the head's GroupNorms)
OPT_EVAL = {"gn_silu_conv3x3_fused": 44, "group_norm": 17, "cross_attention": 16}
OPT_DECODE = {"gn_silu_conv3x3_fused": 28, "group_norm": 2, "cross_attention": 0}
# How many of one eval's 44 chains run at each of OPT_CHAINS' first 18
# (the down path's 16, the middle block's 4, the up path's 24): the weights
# of row 7's per-eval sum of device times
OPT_EVAL_CHAINS = [2, 5, 1, 5, 1, 1, 5, 1, 4, 7, 3, 2, 1, 1, 1, 1, 1, 2]
# The OPT_GN map beyond 8 CTAs' shared memory: row 5 re-reads part of it
OPT_GN_REREAD = (2, 256, 256, 128)
# rel-L2 against the plain version on the same inputs: float32 differs in
# summation order; bfloat16 rounds the output (and the chain its normalized
# input, the cross-attention its weights) at 2^-9, and an element whose
# value lies near a rounding midpoint may land one bf16 step away
OPT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The opt-in route against the default route, both bf16 through 50 DDIM
# steps: the routes round at other places (the chain's epilogue adds in bf16
# after a bf16 cast, cuDNN adds the bias before it), and 50 steps of a
# random-weight U-Net carry the differences on; rel-L2 of latents and images
OPT_ROUTE_TOL = 1e-1

# Full-width U-Net, card vs CPU float32: float32 differs in summation order
# through ~70 layers; bfloat16 stores weights and activations in 8 bits of
# mantissa throughout, which moves these weights' output by rel-L2 8.9e-3
# (measured on the H100); the bound allows about 2x that for other weights
# and machines, so a kernel fault that moves the output by a few times
# bf16's own rounding fails.  In the int8 modes summation order also flips a code
# where a value lies within float32 noise of a rounding midpoint; the flip
# moves its 3x3 neighbourhood by a whole step, and later chains' rounding
# turns that into more flips.  The card must still agree with the CPU at
# least twice as closely as the int8 modes move the output (rel-L2 2.7e-3
# on these weights), so that the check sees a missing or wrong int8 route.
UNET_TOL = {"float32": 1e-3, "float32 xla": 1e-3, "bfloat16": 2e-2,
            "int8 float32": 1.3e-3}  # rel L2

# DeepCache: a shallow pass fed a fresh cache runs the same kernels on the
# same tensors as the full pass (bit-equal expected); a tenth of bf16's own
# error on these weights (8.9e-3), and a wrong skip or block index moves the
# output by about 1
DEEPCACHE_TOL = 1e-3  # rel L2

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


def time_b2b_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """Mean time of ``n`` back-to-back calls of ``fn()`` between two CUDA
    events: the kernel's throughput, or its host time where that is longer,
    without the launch latency that a single timed call pays."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20, launches: list | None = None,
              by_kernel: dict | None = None) -> float:
    """Device time per call of ``fn()``: the time of every kernel the card
    ran during ``n`` back-to-back calls under ``torch.profiler``, summed
    over all of them and divided by ``n``.  Beside ``time_ms`` (wall time
    of one call, the wrapper's host time included) it separates what the
    card spends from what the host spends.  ``launches``, when given, gets
    the kernel launches per call appended; ``by_kernel`` each kernel's
    device time per call, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us, count, kernels = 0.0, 0, {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                total_us += dev_us
                count += evt.count
                kernels[evt.key] = dev_us / 1e3 / n
        return total_us, count, kernels

    fn()
    torch.cuda.synchronize()
    # A window now and then comes back without some or all of its kernels,
    # which only lowers it: windows until two agree (the same launches, the
    # time within 10%), the larger of the two kept.
    best = window()
    for _ in range(3):
        got = window()
        agree = got[1] == best[1] > 0 and abs(got[0] - best[0]) <= 0.1 * max(got[0], best[0])
        best = max(best, got, key=lambda w: (w[1], w[0]))
        if agree:
            break
    total_us, count, kernels = best
    check(count > 0, "the profiler recorded no kernel in four windows")
    if launches is not None:
        launches.append(count / n)
    if by_kernel is not None:
        by_kernel.update(kernels)
    return total_us / 1e3 / n


def errors(got, ref):
    diff = (got.float() - ref.float())
    max_abs = float(diff.abs().max())
    rel_l2 = float(diff.norm() / ref.float().norm().clamp_min(1e-30))
    return max_abs, rel_l2


def _path_wrappers():
    """The wrappers that count launches by path ("wgmma", "mma.sync",
    "fma"): the flash kernels, the fused FFN, the s8 conv, the fused chain,
    the cross-attention and the W8A8 FFN."""
    from ldm_tf2_tpu_torch.ops import cross_attention as ca
    from ldm_tf2_tpu_torch.ops import flash_attention as fa
    from ldm_tf2_tpu_torch.ops import fused_conv as fc
    from ldm_tf2_tpu_torch.ops import quant_conv as qc
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_int8

    return {"flash_attention": fa.flash_attention,
            "flash_backward_dq": fa.flash_backward_dq,
            "flash_backward_dkv": fa.flash_backward_dkv,
            "flash_attention_pv_int8": fa.flash_attention_pv_int8,
            "fused_ffn": fused_ffn, "s8_conv3x3": qc.s8_conv3x3,
            "gn_silu_conv3x3_fused": fc.gn_silu_conv3x3_fused,
            "cross_attention": ca.cross_attention, "fused_ffn_int8": fused_ffn_int8}


def paths_of(fn) -> dict:
    """The launches by path of ``fn()`` (one or more wrappers)."""
    wrappers = _path_wrappers()
    before = {k: dict(w.launches_by_path) for k, w in wrappers.items()}
    fn()
    out = {}
    for k, w in wrappers.items():
        ran = {p: n - before[k][p] for p, n in w.launches_by_path.items()}
        if any(ran.values()):
            out[k] = ran
    return out


def _mode_wrappers():
    """The wrappers that count launches by the GroupNorm cluster plan's
    mode ("resident", "reread"): rows 8 and 9, and row 5."""
    from ldm_tf2_tpu_torch.ops import group_norm as gn
    from ldm_tf2_tpu_torch.ops import quant_conv as qc

    return {"gn_silu_quant": qc.gn_silu_quant, "group_norm_fused": gn.group_norm_fused}


def modes_of(fn) -> dict:
    """The launches by mode of ``fn()``, per wrapper of ``_mode_wrappers``."""
    wrappers = _mode_wrappers()
    before = {k: dict(w.launches_by_path) for k, w in wrappers.items()}
    fn()
    return {k: {m: n - before[k][m] for m, n in w.launches_by_path.items()}
            for k, w in wrappers.items()}


def want_path(dtype_name: str, s: int) -> str:
    """The path a launch must take: wgmma for bf16 at the models' head dims,
    the FMA path for float32."""
    if dtype_name == "float32":
        return "fma"
    return "wgmma" if s in WGMMA_HEAD_DIMS else "mma.sync"


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
            out = []
            paths = paths_of(lambda: out.append(flash_attention(q, k, v, scale)))
            got = out[0]
            ref = dot_product_attention(q.float(), k.float(), v.float(), scale)
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = ATTN_TOL[name]
            path = want_path(name, s)
            ok = (max_abs < tol_abs and rel < tol_rel
                  and paths == {"flash_attention": {**dict.fromkeys(paths["flash_attention"], 0),
                                                    path: 1}})
            ms = time_ms(lambda: flash_attention(q, k, v, scale))
            plain = time_ms(lambda: dot_product_attention(q, k, v, scale))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            ms_b2b = time_b2b_ms(lambda: flash_attention(q, k, v, scale))
            lib_b2b = time_b2b_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            dev = device_ms(lambda: flash_attention(q, k, v, scale))
            lib_dev = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            bms, by = bound_ms(nbytes, 4.0 * b * h * tq * tk * s, name)
            row = dict(shape=[b, tq, tk, h, s], dtype=name, max_abs_err=max_abs,
                       rel_l2=rel, ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bms, bound_by=by, paths=paths["flash_attention"],
                       ms_b2b=ms_b2b, library_ms_b2b=lib_b2b, device_ms=dev,
                       library_device_ms=lib_dev)
            results["flash_attention"].append(row)
            log(f"flash_attention {name} q[{b},{tq},{h},{s}] kv {tk}: max_abs "
                f"{max_abs:.3e} (tol {tol_abs:g}) rel_l2 {rel:.3e} (tol "
                f"{tol_rel:g}) path {paths['flash_attention']} (want {path}) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
                f"{plain:.4f} sdpa {lib:.4f} bound {bms:.4f} ({by}); ratio to sdpa "
                f"{ms / lib:.3f}, to bound {ms / bms:.1f}; back to back {ms_b2b:.4f}, sdpa "
                f"{lib_b2b:.4f}; device {dev:.4f}, sdpa {lib_dev:.4f}")
        for m, d in FFN_SHAPES:
            f = 4 * d
            x = randn(1, m, d).to(dtype)
            lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
            ws = [randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
                  randn(d, f, scale=d**-0.5), randn(f, scale=0.1),
                  randn(f, d, scale=f**-0.5), randn(d, scale=0.1)]
            ws = [w.to(dtype) for w in ws]
            out = []
            took = paths_of(lambda: out.extend(fused_ffn(x, lns, lnb, *ws) for _ in range(2)))
            got = out[0]
            ref = _plain_ffn(x.float(), lns, lnb, *[w.float() for w in ws])
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = FFN_TOL[name]
            path = "wgmma" if dtype == torch.bfloat16 else "fma"
            took = took.get("fused_ffn", {})
            same = bool(torch.equal(out[0], out[1]))  # deterministic
            ok = (max_abs < tol_abs and rel < tol_rel and same
                  and took == {**dict.fromkeys(took, 0), path: 2})
            ms = time_ms(lambda: fused_ffn(x, lns, lnb, *ws))
            plain = time_ms(lambda: _plain_ffn(x, lns, lnb, *ws))
            parts = {}  # the kernel's launches: LN, up, down (and the split pass)
            dev = device_ms(lambda: fused_ffn(x, lns, lnb, *ws), by_kernel=parts)
            # the library yardstick: the unfused chain of PyTorch calls
            w1 = torch.cat([ws[0], ws[2]], dim=1).T.contiguous()
            b1 = torch.cat([ws[1], ws[3]])
            w2t = ws[4].T.contiguous()
            lnd = (lns.to(dtype), lnb.to(dtype))

            def library():
                h = F.linear(F.layer_norm(x, (d,), *lnd), w1, b1)
                return F.linear(h[..., :f] * F.gelu(h[..., f:]), w2t, ws[5]) + x

            lib = time_ms(library)
            lib_dev = device_ms(library)
            nbytes = (2 * x.numel() + sum(w.numel() for w in ws)) * x.element_size() \
                + 2 * d * 4
            bms, by = bound_ms(nbytes, 6.0 * m * d * f, name)
            row = dict(shape=[m, d], dtype=name, max_abs_err=max_abs,
                       rel_l2=rel, ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bms, bound_by=by, device_ms=dev, library_device_ms=lib_dev,
                       paths=took, deterministic=same)
            results["fused_ffn"].append(row)
            parts = ", ".join(f"{(re.findall(r'ffn_[a-z0-9]+', k) or [k[:24]])[0]} {v:.4f}"
                              for k, v in parts.items())
            log(f"fused_ffn {name} M {m} d {d}: max_abs {max_abs:.3e} (tol "
                f"{tol_abs:g}) rel_l2 {rel:.3e} (tol {tol_rel:g}) two calls equal {same} "
                f"path {took} (want {path}) {'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
                f"{plain:.4f} library {lib:.4f} bound {bms:.4f} ({by}); device {dev:.4f} "
                f"({parts}), library {lib_dev:.4f}")
        if dtype == torch.bfloat16:  # row 2 over one eval's 16 FFNs, CFG batch 4 and 8
            rows = results["fused_ffn"]
            for cfg, part in ((4, rows[:4]), (8, rows[4:8])):
                EVAL_SUMS[f"fused_ffn cfg {cfg}"] = sums = {
                    k: sum(n * r[k] for n, r in zip(FFN_EVAL, part))
                    for k in ("device_ms", "library_device_ms", "bound_ms")}
                log(f"fused_ffn per U-Net eval at CFG batch {cfg} ({sum(FFN_EVAL)} FFNs, "
                    f"FFN_EVAL): device {sums['device_ms']:.4f} ms, library "
                    f"{sums['library_device_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")
    phase_int8_kernels(results, randn)
    phase_ffn_int8_kernel(results, randn)
    phase_backward_kernels(results, randn)
    phase_opt_in_kernels(results, randn)
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
    # the arithmetic rows 8 and 5 rest on, over every float of its range
    counts = qc.gn_silu_checks(torch.device("cuda"))
    log(f"gn_silu_checks: reciprocal != __frcp_rn on [1, 2^126) {counts[0]}, expf "
        f"decreasing steps on [-104, 0] {counts[1]}, negative z with |silu| >= the amax "
        f"bound {counts[2]} (want 0, 0, 0)")
    check(counts == [0, 0, 0], f"gn_silu_checks {counts}")
    # stage 1 at every serving input shape, plus a map the TPU streams: one
    # launch a call (the profiler's count), resident in the clusters' shared
    # memory at every serving shape, re-read at the streamed map, two calls
    # bit-equal
    gn_shapes = sorted({shape for shape, _, _ in chains}) + [STREAMED_MAP]
    gnq_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for shape in gn_shapes if dtype == torch.bfloat16 else gn_shapes[:1]:
            c = shape[-1]
            x = (randn(*shape) * 2 + 0.5).to(dtype)
            gamma, beta = randn(c, scale=0.5) + 1.0, randn(c, scale=0.5)
            out = []
            mode = modes_of(lambda: out.extend(qc.gn_silu_quant(x, gamma, beta)
                                               for _ in range(2)))["gn_silu_quant"]
            (y8, sa), (y8b, sab) = out
            r8, rsa = qc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5)
            torch.cuda.synchronize()
            sa_rel = float(((sa - rsa).abs() / rsa).max())
            diff = (y8.int() - r8.int()).abs()
            codes_max, flipped = int(diff.max()), float((diff > 0).float().mean())
            same = bool(torch.equal(y8, y8b) and torch.equal(sa, sab))
            want = "reread" if shape == STREAMED_MAP else "resident"
            ms = time_ms(lambda: qc.gn_silu_quant(x, gamma, beta))
            plain = time_ms(lambda: qc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5))
            per_call = []
            dev = device_ms(lambda: qc.gn_silu_quant(x, gamma, beta), launches=per_call)
            ok = (sa_rel <= 1e-6 and codes_max <= 1 and flipped <= 1e-3 and same
                  and mode == {**dict.fromkeys(mode, 0), want: 2} and per_call[0] == 1.0)
            n = x.numel()
            # x read, codes written; ~14 float32 operations an element
            bms, by = bound_ms(n * (x.element_size() + 1), 14.0 * n, "float32")
            # row 9: the map the TPU streams (beyond its VMEM slab)
            key = "gn_silu_quant_stream" if shape == STREAMED_MAP else "gn_silu_quant"
            results[key].append(dict(
                shape=list(shape), dtype=name, max_abs_err=float(codes_max), ok=ok,
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                device_ms=dev, library_device_ms=None, device_launches=per_call[0],
                paths=mode, deterministic=same))
            if dtype == torch.bfloat16:
                gnq_rows[shape] = results[key][-1]
            log(f"gn_silu_quant {name} {list(shape)}: sa rel {sa_rel:.2e} (tol 1e-6), "
                f"codes max diff {codes_max} (tol 1) on {flipped:.2e} of them (tol 1e-3), "
                f"two calls equal {same}, path {mode} (want {want}), {per_call[0]:g} "
                f"launches a call (want 1) {'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
                f"{plain:.4f} bound {bms:.4f} ({by}); device {dev:.4f}")
    # row 8 over one serve eval's 29 calls
    EVAL_SUMS["gn_silu_quant"] = sums = {
        k: sum(n * gnq_rows[shape][k] for n, (shape, _, _) in zip(SERVE_EVAL_CHAINS, chains))
        for k in ("device_ms", "bound_ms")}
    log(f"gn_silu_quant per U-Net eval at CFG batch 8 ({sum(SERVE_EVAL_CHAINS)} calls, "
        f"SERVE_EVAL_CHAINS): device {sums['device_ms']:.4f} ms, bound "
        f"{sums['bound_ms']:.4f} ms")

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
        out = []
        took = paths_of(lambda: out.append(
            qc.s8_conv3x3(*args, out_dtype=torch.bfloat16, **extra)))["s8_conv3x3"]
        got = out[0]
        want = qc._plain_s8_conv3x3(*args, extra.get("time_add"),
                                    extra.get("residual_add"), torch.bfloat16)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, want)) and took == {**dict.fromkeys(took, 0), "wgmma": 1}
        err = float((got.float() - want.float()).abs().max())
        ms = time_ms(lambda: qc.s8_conv3x3(*args, out_dtype=torch.bfloat16, **extra))
        plain = time_ms(lambda: qc._plain_s8_conv3x3(
            *args, extra.get("time_add"), extra.get("residual_add"), torch.bfloat16),
            iters=3, warmup=1)
        y32, w32 = y8.permute(0, 3, 1, 2).float(), w8.permute(0, 3, 1, 2).float()
        lib = time_ms(lambda: F.conv2d(y32, w32, padding=1))
        dev = device_ms(lambda: qc.s8_conv3x3(*args, out_dtype=torch.bfloat16, **extra))
        lib_dev = device_ms(lambda: F.conv2d(y32, w32, padding=1))
        # the bf16 chain that the int8 mode replaces, on bf16 activations
        x = randn(*shape).bfloat16()
        wb = randn(cout, cin, 3, 3, scale=cin**-0.5).bfloat16()
        gamma, beta = randn(cin) + 1.0, randn(cin)
        chain = time_ms(lambda: gn_silu_conv3x3(x, gamma, beta, wb, bias, **extra))
        chain_dev = device_ms(lambda: gn_silu_conv3x3(x, gamma, beta, wb, bias, **extra)) \
            if (shape, cout, epilogue) == chains[0] else None
        m = b * h * w
        nbytes = m * cin + 9 * cin * cout + 2 * m * cout + (
            2 * m * cout if epilogue == "residual" else 2 * b * cout)
        bms, by = bound_ms(nbytes, 2.0 * m * cout * 9 * cin, "int8")
        results["s8_conv3x3"].append(dict(
            shape=[*shape, cout], epilogue=epilogue, dtype="bfloat16", max_abs_err=err,
            ok=ok, ms=ms, plain_ms=plain, library_ms=lib, bf16_chain_ms=chain,
            bound_ms=bms, bound_by=by, device_ms=dev, library_device_ms=lib_dev, paths=took))
        log(f"s8_conv3x3 {list(shape)} -> {cout} +{epilogue}: equal to the plain "
            f"version, path {took} (want wgmma) {'PASS' if ok else 'FAIL'} (max abs "
            f"{err:.1e}); ms {ms:.4f} plain {plain:.4f} cudnn-f32 {lib:.4f} bf16 chain "
            f"{chain:.4f} bound {bms:.4f} ({by}); device {dev:.4f}, cudnn-f32 {lib_dev:.4f}")
        if (shape, cout, epilogue) == chains[0]:
            phase_int8_chain(results, randn, shape, cout, bias, extra, chain, chain_dev)
    # row 11 over one serve eval's 29 int8 convs
    conv_rows = results["s8_conv3x3"][:len(chains)]
    EVAL_SUMS["s8_conv3x3"] = sums = {
        k: sum(n * r[k] for n, r in zip(SERVE_EVAL_CHAINS, conv_rows))
        for k in ("device_ms", "library_device_ms", "bound_ms")}
    log(f"s8_conv3x3 per U-Net eval at CFG batch 8 ({sum(SERVE_EVAL_CHAINS)} convs, "
        f"SERVE_EVAL_CHAINS): device {sums['device_ms']:.4f} ms, cudnn-f32 "
        f"{sums['library_device_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, t, h, s in ((8, 1024, 8, 40), (4, 1024, 1, 512)):
            q, k, v = (randn(b, t, h, s).to(dtype) for _ in range(3))
            scale = s**-0.5
            out = []
            paths = paths_of(lambda: out.append(flash_attention_pv_int8(q, k, v, scale)))
            got = out[0]
            ref = _plain_pv_int8(q.float(), k.float(), v.float(), scale)
            torch.cuda.synchronize()
            max_abs, rel = errors(got, ref)
            tol_abs, tol_rel = PV_TOL[name]
            took = paths["flash_attention_pv_int8"]
            path = want_path(name, s)
            ok = (max_abs <= tol_abs and rel <= tol_rel
                  and took == {**dict.fromkeys(took, 0), path: 1})
            ms = time_ms(lambda: flash_attention_pv_int8(q, k, v, scale))
            plain = time_ms(lambda: _plain_pv_int8(q, k, v, scale), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
            parts = {}  # the pre-pass and the main kernel
            dev = device_ms(lambda: flash_attention_pv_int8(q, k, v, scale), by_kernel=parts)
            lib_dev = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            parts = {("pre-pass" if "v_quant" in k_ else "main"): round(ms_, 4)
                     for k_, ms_ in parts.items()}
            flops = 2.0 * b * h * t * t * s
            qk_type = "bfloat16" if dtype == torch.bfloat16 else "float32"
            t_ops = flops / PEAK_OPS[qk_type] + flops / PEAK_OPS["int8"]
            t_bytes = 4 * q.numel() * q.element_size() / PEAK_BYTES
            bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                                 else "bytes")
            results["flash_attention_pv_int8"].append(dict(
                shape=[b, t, t, h, s], dtype=name, max_abs_err=max_abs, rel_l2=rel,
                ok=ok, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, device_ms=dev, library_device_ms=lib_dev, paths=took))
            log(f"flash_attention_pv_int8 {name} q[{b},{t},{h},{s}]: max_abs "
                f"{max_abs:.3e} (tol {tol_abs:g}) rel_l2 {rel:.3e} (tol {tol_rel:g}) "
                f"path {took} (want {path}) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain {plain:.4f} sdpa "
                f"{lib:.4f} bound {bms:.4f} ({by}); device {dev:.4f} {parts}, sdpa "
                f"{lib_dev:.4f}")


def phase_int8_chain(results, randn, shape, cout, bias, extra, bf16_chain_ms,
                     bf16_chain_dev):
    """Row 10, the TPU's whole int8 ResBlock chain: ``gn_silu_conv3x3_int8``
    (rows 8 and 11 back to back) against the plain chain, bf16."""
    import torch

    from ldm_tf2_tpu_torch.ops import quant_conv as qc

    b, h, w, cin = shape
    x = (randn(*shape) * 2 + 0.5).bfloat16()
    gamma, beta = randn(cin, scale=0.5) + 1.0, randn(cin, scale=0.5)
    w8, ws = qc.int8_conv_weights(randn(cout, cin, 3, 3, scale=cin**-0.5))
    got = qc.gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, bias, **extra)

    def plain():
        y8, sa = qc._plain_gn_silu_quant(x, gamma, beta, 32, 1e-5)
        return qc._plain_s8_conv3x3(y8, sa, w8, ws, bias, extra.get("time_add"),
                                    extra.get("residual_add"), x.dtype)

    want = plain()
    torch.cuda.synchronize()
    max_abs, rel = errors(got, want)
    ok = rel < CHAIN8_TOL and bool(torch.isfinite(got.float()).all())
    ms = time_ms(lambda: qc.gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, bias, **extra))
    plain_ms = time_ms(plain, iters=3, warmup=1)
    dev = device_ms(lambda: qc.gn_silu_conv3x3_int8(x, gamma, beta, w8, ws, bias, **extra))
    m = b * h * w
    nbytes = 2 * m * cin + 9 * cin * cout + 2 * m * cout + 2 * b * cout
    bms, by = bound_ms(nbytes, 2.0 * m * cout * 9 * cin, "int8")
    results["int8_chain"].append(dict(
        shape=[*shape, cout], dtype="bfloat16", max_abs_err=max_abs, rel_l2=rel, ok=ok,
        ms=ms, plain_ms=plain_ms, library_ms=bf16_chain_ms, bound_ms=bms, bound_by=by,
        device_ms=dev, library_device_ms=bf16_chain_dev))
    log(f"int8 chain (gn_silu_quant + s8_conv3x3) {list(shape)} -> {cout}: rel_l2 "
        f"{rel:.3e} (tol {CHAIN8_TOL:g}) max_abs {max_abs:.3e} {'PASS' if ok else 'FAIL'}; "
        f"ms {ms:.4f} plain {plain_ms:.4f} bf16 chain {bf16_chain_ms:.4f} bound "
        f"{bms:.4f} ({by}); device {dev:.4f}, bf16 chain {bf16_chain_dev:.4f}")


def phase_ffn_int8_kernel(results, randn):
    """Row 4, the W8A8 FFN, against its plain version on the card at the
    U-Net's FFN shapes (CFG batch 8) and one M that is not a multiple of
    128, in bf16 and float32: each call one launch on the wgmma path (a
    thread-block cluster of ``ffn8_plan``'s size), two calls bit-equal,
    within ``FFN8_TOL`` with at most ``FFN8_FLIP_ROWS`` of rows moved by a
    code flip; timed in bf16 beside the plain version, its bound and row
    2's bf16 fused FFN at the same shape.  The weights are quantized once
    per shape, outside the timing."""
    import torch

    from ldm_tf2_tpu_torch.ops import fused_ffn as ff

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for m, d in FFN8_SHAPES:
            f = 4 * d
            x = randn(1, m, d).to(dtype)
            lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
            w1v, w1g = (randn(d, f, scale=d**-0.5).to(dtype) for _ in range(2))
            w2 = randn(f, d, scale=f**-0.5).to(dtype)
            b1v, b1g, b2 = (randn(n, scale=0.1).to(dtype) for n in (f, f, d))
            q = ff.quantize_ffn_weights(w1v, w1g, w2)
            args = (x, lns, lnb, q, b1v, b1g, b2)
            before = ff.fused_ffn_int8.launches, dict(ff.fused_ffn_int8.launches_by_path)
            got = ff.fused_ffn_int8(*args)
            took = {p: n - before[1][p] for p, n in ff.fused_ffn_int8.launches_by_path.items()
                    if n - before[1][p]}
            one = ff.fused_ffn_int8.launches - before[0] == 1 and took == {"wgmma": 1}
            same = bool(torch.equal(got, ff.fused_ffn_int8(*args)))
            want = ff._plain_ffn_int8(*args)
            torch.cuda.synchronize()
            max_abs, rel = errors(got, want)
            row_err = (got.float() - want.float()).abs().amax(dim=-1)
            flipped = float((row_err > 1e-3).float().mean())
            cluster = ff.ffn8_plan(m, d, f, dtype)["cluster"]
            ok = (one and same and rel <= FFN8_TOL[name] and max_abs <= 0.1
                  and flipped <= FFN8_FLIP_ROWS and bool(torch.isfinite(got.float()).all()))
            timed = dtype == torch.bfloat16
            ms = time_ms(lambda: ff.fused_ffn_int8(*args)) if timed else None
            plain = time_ms(lambda: ff._plain_ffn_int8(*args), iters=3, warmup=1) \
                if timed else None
            bf16 = time_ms(lambda: ff.fused_ffn(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2)) \
                if timed else None
            per_call = []
            dev = device_ms(lambda: ff.fused_ffn_int8(*args), launches=per_call) \
                if timed else None
            bf16_dev = device_ms(lambda: ff.fused_ffn(x, lns, lnb, w1v, b1v, w1g, b1g, w2,
                                                      b2)) if timed else None
            if timed:  # the profiler sees one kernel a call (it drops one now and then)
                ok = ok and round(per_call[0]) == 1
            # x read, out written, 3 d x F int8 weights and their scales read
            nbytes = 2 * m * d * x.element_size() + 3 * d * f + 4 * (2 * f + d)
            bms, by = bound_ms(nbytes, 6.0 * m * d * f, "int8")
            results["fused_ffn_int8"].append(dict(
                shape=[m, d], dtype=name, max_abs_err=max_abs, rel_l2=rel,
                rows_flipped=flipped, one_launch=one, bit_equal=same, cluster=cluster, ok=ok,
                ms=ms, plain_ms=plain, library_ms=None, bf16_ffn_ms=bf16,
                bf16_ffn_device_ms=bf16_dev, bound_ms=bms, bound_by=by, device_ms=dev,
                library_device_ms=None))
            times = "" if not timed else (
                f"; ms {ms:.4f} plain {plain:.4f} row-2 bf16 FFN {bf16:.4f} "
                f"bound {bms:.4f} ({by}); device {dev:.4f} in {per_call[0]:g} launches, "
                f"row-2 bf16 FFN {bf16_dev:.4f}")
            log(f"fused_ffn_int8 {name} M {m} d {d}: one wgmma launch on a cluster of "
                f"{cluster} {one}, two calls bit-equal {same}, rel_l2 {rel:.3e} (tol "
                f"{FFN8_TOL[name]:g}) max_abs {max_abs:.3e} (tol 0.1), rows with a code "
                f"flip {flipped:.2%} (at most {FFN8_FLIP_ROWS:.0%}) "
                f"{'PASS' if ok else 'FAIL'}{times}")


# Device times summed over one U-Net eval's calls of a kernel, the library
# call's and the bound, by row: 7 (``phase_opt_in_kernels``, bf16), 11, 8
# and 2 (at CFG batch 4 and 8; ``phase_kernels``), 5 (``phase_opt_in``)
EVAL_SUMS: dict = {}
# Row 5's bf16 rows by (shape, eps, SiLU), for its per-eval sum
GN_ROWS: dict = {}


def _one_path(took: dict) -> str:
    """The path of a call that launched its kernel once."""
    ran = [p for p, n in took.items() if n]
    check(len(ran) == 1 and took[ran[0]] == 1, f"one launch expected, got {took}")
    return ran[0]


def phase_opt_in_kernels(results, randn):
    """The opt-in kernels (GroupNorm, GroupNorm stats, the GN+SiLU+3x3
    chain, short-kv cross-attention), each against its plain version on the
    card at every shape of the opt-in main path, in float32 and bf16.  Times
    in bf16 at every shape (float32 at the first only).  Each chain and
    cross-attention launch's path is held to wgmma in bf16 and FMA in
    float32; row 7's bf16 device times are also summed over one U-Net
    eval's chains (``EVAL_SUMS``)."""
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops import cross_attention as ca
    from ldm_tf2_tpu_torch.ops import fused_conv as fc
    from ldm_tf2_tpu_torch.ops import group_norm as gn

    def row(name, shape, dtype, got, want, timed, fns, nbytes, ops, ops_type, **extra):
        pairs = list(zip(got, want))
        rel = max(errors(a, b)[1] for a, b in pairs)
        max_abs = max(errors(a, b)[0] for a, b in pairs)
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok = finite and rel < OPT_TOL[dtype]
        if "path" in extra:  # the one launch took the path its dtype must take
            ok = ok and extra["path"] == {"bfloat16": "wgmma", "float32": "fma"}[dtype]
        if "want_mode" in extra:  # both calls in the plan's mode, bit-equal
            mode = extra["mode"]
            ok = (ok and mode == {**dict.fromkeys(mode, 0), extra["want_mode"]: 2}
                  and extra["deterministic"])
        times = {k: (time_ms(f) if timed else None) for k, f in fns.items()}
        b2b = {k: (time_b2b_ms(fns[k]) if timed else None) for k in ("kernel", "library")}
        per_call = []  # the kernel's launches per call, from the profiler
        dev = {k: (device_ms(fns[k], launches=per_call if k == "kernel" else None)
                   if timed else None) for k in ("kernel", "library")}
        if name in ("group_stats", "group_norm_fused"):  # rows 5 and 6: one launch a call
            if not per_call:
                device_ms(fns["kernel"], n=3, launches=per_call)
            ok = ok and per_call[0] == 1.0
        bms, by = bound_ms(nbytes, ops, ops_type)
        results[name].append(dict(
            shape=list(shape), dtype=dtype, max_abs_err=max_abs, rel_l2=rel, ok=ok,
            ms=times["kernel"], plain_ms=times["plain"], library_ms=times["library"],
            bound_ms=bms, bound_by=by, device_ms=dev["kernel"],
            library_device_ms=dev["library"], ms_b2b=b2b["kernel"],
            library_ms_b2b=b2b["library"],
            device_launches=per_call[0] if per_call else None, **extra))
        note = "" if not timed else (
            f"; ms {times['kernel']:.4f} plain {times['plain']:.4f} library "
            f"{times['library']:.4f} bound {bms:.4f} ({by}); back to back "
            f"{b2b['kernel']:.4f}, library {b2b['library']:.4f}; device {dev['kernel']:.4f} "
            f"in {per_call[0]:g} launches a call, library {dev['library']:.4f}")
        log(f"{name} {dtype} {list(shape)}{' ' + str(extra) if extra else ''}: rel_l2 "
            f"{rel:.3e} (tol {OPT_TOL[dtype]:g}) max_abs {max_abs:.3e} finite {finite} "
            f"{'PASS' if ok else 'FAIL'}{note}")

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        f32_ops = "bfloat16" if dtype == torch.bfloat16 else "float32"
        for i, (shape, eps, act) in enumerate(OPT_GN):
            timed = dtype == torch.bfloat16 or i == 0
            c = shape[-1]
            x = (randn(*shape) * 2 + 0.5).to(dtype)
            gamma, beta = randn(c, scale=0.5) + 1.0, randn(c, scale=0.5)
            n, elem = x.numel(), x.element_size()
            out = []
            mode = modes_of(lambda: out.extend(gn.group_norm_fused(x, gamma, beta, 32, eps, act)
                                               for _ in range(2)))["group_norm_fused"]
            got = out[0]
            want = gn._plain_group_norm_fused(x, gamma, beta, 32, eps, act)
            xn = x.permute(0, 3, 1, 2)  # channels-last NCHW view
            gd, bd = gamma.to(dtype), beta.to(dtype)
            row("group_norm_fused", shape, name, [got], [want], timed,
                {"kernel": lambda: gn.group_norm_fused(x, gamma, beta, 32, eps, act),
                 "plain": lambda: gn._plain_group_norm_fused(x, gamma, beta, 32, eps, act),
                 "library": lambda: F.group_norm(xn, 32, gd, bd, eps)},
                2 * n * elem + 8 * c, 12.0 * n, "float32", eps=eps, silu=act, mode=mode,
                want_mode="reread" if shape == OPT_GN_REREAD else "resident",
                deterministic=bool(torch.equal(out[0], out[1])))
            if dtype == torch.bfloat16:
                GN_ROWS[(shape, eps, act)] = results["group_norm_fused"][-1]
            if act:
                continue  # the stats do not depend on the activation
            mean, rstd = gn.group_stats(x, 32, eps)
            rmean, rrstd = gn._plain_group_stats(x, 32, eps)
            grouped = x.reshape(shape[0], -1, 32, c // 32)
            row("group_stats", shape, name, [mean, rstd], [rmean, rrstd], timed,
                {"kernel": lambda: gn.group_stats(x, 32, eps),
                 "plain": lambda: gn._plain_group_stats(x, 32, eps),
                 "library": lambda: torch.var_mean(grouped, dim=(1, 3))},
                n * elem + 8 * shape[0] * c, 3.0 * n, "float32", eps=eps)
        for i, (shape, cout, epilogue) in enumerate(OPT_CHAINS):
            timed = dtype == torch.bfloat16 or i == 0
            b, h, w, cin = shape
            x = randn(*shape).to(dtype)
            gamma, beta = randn(cin, scale=0.5) + 1.0, randn(cin, scale=0.5)
            wk = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5).to(dtype)
            bias = randn(cout, scale=0.1).to(dtype)
            extra = {}
            if epilogue == "t":
                extra["time_add"] = randn(b, cout).to(dtype)
            elif epilogue == "residual":
                extra["residual_add"] = randn(b, h, w, cout).to(dtype)
            args = (x, gamma, beta, wk, bias)
            plain_args = (*args, extra.get("time_add"), extra.get("residual_add"), 32, 1e-5)
            out = []
            took = paths_of(lambda: out.append(fc.gn_silu_conv3x3_fused(*args, **extra)))
            got = out[0]
            want = fc._plain_chain(*plain_args)
            m, elem = b * h * w, x.element_size()
            nbytes = (m * cin + 9 * cin * cout + m * cout) * elem + (
                m * cout * elem if epilogue == "residual" else 0)

            def default_chain():  # the bf16 chain of the "auto" route
                return fc.gn_silu_conv3x3(*args, **extra)

            row("gn_silu_conv3x3_fused", (*shape, cout), name, [got], [want], timed,
                {"kernel": lambda: fc.gn_silu_conv3x3_fused(*args, **extra),
                 "plain": lambda: fc._plain_chain(*plain_args),
                 "library": default_chain},
                nbytes, 2.0 * m * cout * 9 * cin, f32_ops, epilogue=epilogue,
                path=_one_path(took.get("gn_silu_conv3x3_fused", {})))
        if dtype == torch.bfloat16:  # row 7 over one U-Net eval's 44 chains
            unet_rows = results["gn_silu_conv3x3_fused"][:len(OPT_EVAL_CHAINS)]
            EVAL_SUMS["gn_silu_conv3x3_fused"] = sums = {
                k: sum(n * r[k] for n, r in zip(OPT_EVAL_CHAINS, unet_rows))
                for k in ("device_ms", "library_device_ms", "bound_ms")}
            log(f"gn_silu_conv3x3_fused per U-Net eval ({sum(OPT_EVAL_CHAINS)} chains, "
                f"OPT_EVAL_CHAINS): device {sums['device_ms']:.4f} ms, default bf16 "
                f"chain {sums['library_device_ms']:.4f} ms, bound "
                f"{sums['bound_ms']:.4f} ms")
        for i, (b, tq, tk, h, sh) in enumerate(OPT_CROSS):
            timed = dtype == torch.bfloat16 or i == 0
            q, k, v = (randn(b, t, h, sh).to(dtype) for t in (tq, tk, tk))
            scale = sh**-0.5
            out = []
            took = paths_of(lambda: out.append(ca.cross_attention(q, k, v, scale)))
            got = out[0]
            want = ca._plain_cross_attention(q, k, v, scale)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            row("cross_attention", (b, tq, tk, h, sh), name, [got], [want], timed,
                {"kernel": lambda: ca.cross_attention(q, k, v, scale),
                 "plain": lambda: ca._plain_cross_attention(q, k, v, scale),
                 "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)},
                (2 * q.numel() + 2 * k.numel()) * q.element_size(),
                4.0 * b * h * tq * tk * sh, f32_ops,
                path=_one_path(took.get("cross_attention", {})))


def phase_backward_kernels(results, randn):
    """The training path's flash backward: the forward's lse and the dq and
    dk/dv kernels, each against its plain version on the kernel's own
    residuals, with times, bounds and the SDPA backward as the yardstick."""
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, tq, tk, h, s, extreme in BWD_SHAPES:
            q, k, v, do = (randn(b, n, h, s) for n in (tq, tk, tk, tq))
            if extreme:
                q, k = q + 5.0, k - 5.0
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            scale = s**-0.5
            out, lse = fa._launch(q, k, v, scale, with_lse=True)
            di = fa._di(out, do)
            grads = []
            paths = paths_of(lambda: grads.extend(
                (fa.flash_backward_dq(q, k, v, do, lse, di, scale),
                 *fa.flash_backward_dkv(q, k, v, do, lse, di, scale))))
            dq, dk, dv = grads
            path = want_path(name, s)
            args = (q.float(), k.float(), v.float(), do.float(), lse, di, scale)
            ref_lse = fa._plain_forward(q.float(), k.float(), v.float(), scale)[1]
            ref = {"dq": fa._plain_dq(*args), "dkv": fa._plain_dkv(*args)}
            torch.cuda.synchronize()
            lse_err = float((lse - ref_lse).abs().max())
            errs = {"dq": [errors(dq, ref["dq"])],
                    "dkv": [errors(dk, ref["dkv"][0]), errors(dv, ref["dkv"][1])]}
            finite = all(bool(torch.isfinite(x.float()).all()) for x in (dq, dk, dv))
            plain = {"dq": lambda: fa._plain_dq(q, k, v, do, lse, di, scale),
                     "dkv": lambda: fa._plain_dkv(q, k, v, do, lse, di, scale)}
            kernel = {"dq": lambda: fa.flash_backward_dq(q, k, v, do, lse, di, scale),
                      "dkv": lambda: fa.flash_backward_dkv(q, k, v, do, lse, di, scale)}
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
            dot = do.transpose(1, 2)
            lib = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                      retain_graph=True))
            lib_b2b = time_b2b_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                              retain_graph=True))
            lib_dev = device_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                            retain_graph=True))
            flops = 2.0 * b * h * tq * tk * s
            elem = q.element_size()
            # dq reads q, dO, k, v, lse, di and writes dq; dk/dv reads q, dO,
            # k, v, lse, di and writes dk, dv
            io = {"dq": (3 * b * tq + 2 * b * tk) * h * s * elem + 8 * b * h * tq,
                  "dkv": (2 * b * tq + 4 * b * tk) * h * s * elem + 8 * b * h * tq}
            for part, n_ops in (("dq", 3), ("dkv", 4)):
                max_abs = max(e[0] for e in errs[part])
                rel = max(e[1] for e in errs[part])
                took = paths[f"flash_backward_{part}"]
                ok = (finite and rel < BWD_TOL[name] and lse_err < 1e-4
                      and took == {**dict.fromkeys(took, 0), path: 1})
                ms = time_ms(kernel[part])
                ms_b2b = time_b2b_ms(kernel[part])
                dev = device_ms(kernel[part])
                plain_ms = time_ms(plain[part], iters=5)
                bms, by = bound_ms(io[part], n_ops * flops, name)
                results[f"flash_backward_{part}"].append(dict(
                    shape=[b, tq, tk, h, s], extreme=extreme, dtype=name,
                    max_abs_err=max_abs, rel_l2=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                    library_ms=lib, bound_ms=bms, bound_by=by, paths=took, ms_b2b=ms_b2b,
                    library_ms_b2b=lib_b2b, device_ms=dev, library_device_ms=lib_dev))
                log(f"flash_backward_{part} {name} q[{b},{tq},{h},{s}] kv {tk}"
                    f"{' extreme' if extreme else ''}: rel_l2 {rel:.3e} (tol "
                    f"{BWD_TOL[name]:g}) max_abs {max_abs:.3e} lse {lse_err:.1e} "
                    f"finite {finite} path {took} (want {path}) "
                    f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
                    f"{plain_ms:.4f} sdpa-backward {lib:.4f} bound {bms:.4f} ({by}); "
                    f"device {dev:.4f}, sdpa-backward {lib_dev:.4f}")
            rows = [results[f"flash_backward_{p}"][-1] for p in ("dq", "dkv")]
            both, both_b2b = (sum(r[k] for r in rows) for k in ("ms", "ms_b2b"))
            log(f"flash_backward {name} q[{b},{tq},{h},{s}] kv {tk}: dq + dk/dv "
                f"{both:.4f} ms, sdpa-backward {lib:.4f} ms, ratio {both / lib:.3f}; back to "
                f"back {both_b2b:.4f} against {lib_b2b:.4f}, ratio {both_b2b / lib_b2b:.3f}")


def _grad_group(name: str) -> str:
    if ".att_layer" in name:
        return "attention projections"
    if ".ffn.geglu." in name:
        return "GEGLU"
    if ".ffn.dense." in name or "layernorm3" in name:
        return "FFN out + layernorm3"
    if name.endswith("kernel") and ("conv" in name or "sample" in name):
        return "convs"
    return "norms, biases, other dense"


def phase_grad():
    """Parameter gradients of a U-Net at the north-star widths (one block
    per level to spare the CPU), batch 1 at a 32x32 latent, training mode
    with dropout on at a rate that keeps every element (1e-9: the split
    ResidualBlock chain and the attention output dropout run, as in the
    train phase, and neither device drops anything): card against CPU,
    float32, TF32 off."""
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(NORTH_STAR))
    config["unet"].update(num_blocks=1, dropout_rate=1e-9)
    config = validate({**config, "tpu": {"compute_dtype": "float32"}})
    gen = torch.Generator().manual_seed(41)
    x = torch.randn(1, 32, 32, 4, generator=gen)
    ctx = torch.randn(1, 77, 1280, generator=gen)
    target = torch.randn(1, 32, 32, 4, generator=gen)
    t = torch.tensor([437.0])
    grads, seconds = {}, {}
    cpu_unet = factory.build_trainable_unet(config, "cpu", seed=42)
    counters = _counters()
    # the CPU on the default route; the card on it, then with the three
    # opt-in switches on (their kernels' backward recomputes through the
    # plain versions, which compute the default route's function up to
    # rounding, so the same CPU gradients hold both)
    for run in ("cpu", "cuda", "cuda opt-in"):
        device = run.split()[0]
        if device == "cpu":
            unet = cpu_unet
        else:
            unet = factory.build_trainable_unet(config, device, seed=42)
            unet.load_state_dict(cpu_unet.state_dict())
        if run == "cuda opt-in":
            _set_switches("pallas", "pallas", True)
        try:
            start = time.perf_counter()
            before = {k: fn.launches for k, fn in counters.items()}
            out = unet(x.to(device), t.to(device), ctx.to(device), training=True,
                       generator=torch.Generator(device).manual_seed(0))
            loss = ((out - target.to(device)) ** 2).mean()
            names, params = zip(*unet.named_parameters())
            got = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            _set_switches("auto", "auto", False)
        if device == "cuda":
            torch.cuda.synchronize()
            ran = {k: fn.launches - before[k] for k, fn in counters.items()}
            check(ran["flash_backward_dq"] > 0, "the card's backward ran no dq kernel")
            if run == "cuda opt-in":
                check(all(ran[k] > 0 for k in ("group_norm_fused", "cross_attention",
                                                "gn_silu_conv3x3_fused")),
                      f"the opt-in gradient run missed a kernel: {ran}")
        seconds[run] = time.perf_counter() - start
        check(all(g is not None for g in got), f"{run}: a parameter got no gradient")
        grads[run] = {n: g.float().cpu() for n, g in zip(names, got)}
        if device == "cuda":
            del unet
        del out, loss, got
    del cpu_unet
    torch.cuda.empty_cache()
    for run in ("cuda", "cuda opt-in"):
        groups: dict[str, list] = {}
        for n, want in grads["cpu"].items():
            groups.setdefault(_grad_group(n), []).append((grads[run][n].flatten(),
                                                          want.flatten()))
        report = {}
        for group, pairs in groups.items():
            got = torch.cat([a for a, _ in pairs])
            want = torch.cat([b for _, b in pairs])
            report[group] = (float((got - want).norm() / want.norm()), len(pairs))
        ok = all(rel < GRAD_TOL for rel, _ in report.values())
        switches = " with the opt-in switches on" if run == "cuda opt-in" else ""
        log(f"grad{switches}: north-star-width U-Net (1 block per level, "
            f"{len(grads['cpu'])} tensors), batch 1, 32x32, card vs CPU float32 (card "
            f"{seconds[run]:.2f} s, CPU {seconds['cpu']:.1f} s): " + "; ".join(
                f"{g} rel_l2 {r:.2e} ({n} tensors)" for g, (r, n) in report.items())
            + f" (bound {GRAD_TOL:g}) {'PASS' if ok else 'FAIL'}")
        check(ok, f"U-Net gradients{switches} on the card disagree with the CPU's: "
              f"{report}")


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
        # tpu.attention_impl "xla": every self-attention in plain PyTorch,
        # no flash launch (the int8-P.V mode is off under "xla" too)
        from ldm_tf2_tpu_torch.ops import attention as attn
        from ldm_tf2_tpu_torch.ops import flash_attention as fa

        counts = (fa.flash_attention.launches, fa.flash_attention_pv_int8.launches)
        attn.set_attention_impl("xla")
        try:
            out["float32 xla"] = unet(x.cuda(), t.cuda(), ctx.cuda())
            unet.set_serving_modes(attention_pv_int8=True)
            out["float32 xla"] = torch.stack([out["float32 xla"],
                                              unet(x.cuda(), t.cuda(), ctx.cuda())])
            unet.set_serving_modes()
        finally:
            attn.set_attention_impl("auto")
        xla_flash = (fa.flash_attention.launches - counts[0],
                     fa.flash_attention_pv_int8.launches - counts[1])
        unet.set_serving_modes(conv_quant=True, attention_pv_int8=True)
        out8 = unet(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        unet.set_serving_modes()
        unet = unet.to(torch.bfloat16)
        unet.dtype = torch.bfloat16
        out["bfloat16"] = unet(x.cuda(), t.cuda(), ctx.cuda())
        torch.cuda.synchronize()
    del unet
    torch.cuda.empty_cache()
    log(f"unet full width, attention_impl xla (plain, then with int8-P.V on, which "
        f"xla turns off): flash launches {xla_flash[0]}, int8-P.V launches {xla_flash[1]} "
        f"(want 0, 0) {'PASS' if xla_flash == (0, 0) else 'FAIL'}")
    check(xla_flash == (0, 0), f"attention_impl xla launched flash kernels: {xla_flash}")
    for name, y in out.items():
        y = y.float().cpu()
        check(bool(torch.isfinite(y).all()), f"U-Net {name} output not finite")
        if name == "float32 xla":  # the two evals under xla are one function
            check(errors(y[1], y[0])[1] < 1e-6, "xla: the int8-P.V mode changed the output")
            y = y[0]
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

    seconds, launches, images, x0 = _counted_call(
        models, schedule, ids, shape, kwargs)
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
    want = {k: 0 for k in launches}  # the switches off: no other kernel runs
    want.update({"flash_attention": 16 * steps + 1, "fused_ffn": 16 * steps})
    check(launches == want, f"launch counts {launches}, expected {want}")
    check_no_fma("main path")
    launches = {k: launches[k] for k in ("flash_attention", "fused_ffn")}
    profile = phase_profile(models[1], shape)
    run = dict(models=models, config=config, ids=ids, shape=shape, kwargs=kwargs,
               images=images, x0=x0.float().cpu(), seconds=seconds, profile=profile)
    return launches, run


class _Count:
    """A launch count kept under another attribute of a wrapper, read and
    set as ``.launches`` like the others."""

    def __init__(self, owner, attr: str):
        self.owner, self.attr = owner, attr

    @property
    def launches(self) -> int:
        return getattr(self.owner, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.owner, self.attr, value)


# Each counter's launches summed over every path run (``_read``)
PATH_TOTALS: dict = {}


# The launches by path in the last path run (``_read``), and by the
# GroupNorm cluster plan's mode
LAST_PATHS: dict = {}
LAST_MODES: dict = {}


def _reset(counters) -> None:
    """Every count to 0 just before a path run, the counts by path and mode
    too."""
    for fn in counters.values():
        fn.launches = 0
    for fn in (*_path_wrappers().values(), *_mode_wrappers().values()):
        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def _read(counters) -> dict:
    """The counts of one path run, its counters set to 0 just before it
    (``_reset``); also added to ``PATH_TOTALS``.  The launches by path go
    to ``LAST_PATHS``, by mode to ``LAST_MODES``."""
    got = {k: fn.launches for k, fn in counters.items()}
    for k, v in got.items():
        PATH_TOTALS[k] = PATH_TOTALS.get(k, 0) + v
    LAST_PATHS.clear()
    LAST_PATHS.update({k: dict(fn.launches_by_path) for k, fn in _path_wrappers().items()})
    LAST_MODES.clear()
    LAST_MODES.update({k: dict(fn.launches_by_path) for k, fn in _mode_wrappers().items()})
    return got


def check_no_fma(what: str) -> None:
    """A bf16 path run: no launch of the last run took the FMA path, and
    every FFN and s8 conv launch took wgmma."""
    fma = {k: p["fma"] for k, p in LAST_PATHS.items() if p["fma"]}
    log(f"{what}: launches by path {LAST_PATHS}")
    check(not fma, f"{what}: bf16 launches took the FMA path: {fma}")
    off = {k: LAST_PATHS[k] for k in ("fused_ffn", "s8_conv3x3")
           if sum(LAST_PATHS[k].values()) != LAST_PATHS[k]["wgmma"]}
    check(not off, f"{what}: FFN or s8 conv launches off the wgmma path: {off}")


def _counters():
    from ldm_tf2_tpu_torch.ops import cross_attention as ca
    from ldm_tf2_tpu_torch.ops import flash_attention as fa
    from ldm_tf2_tpu_torch.ops import fused_conv as fc
    from ldm_tf2_tpu_torch.ops import group_norm as gn
    from ldm_tf2_tpu_torch.ops import quant_conv as qc
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_int8

    return {"flash_attention": fa.flash_attention, "fused_ffn": fused_ffn,
            "fused_ffn_int8": fused_ffn_int8,
            "gn_silu_quant": qc.gn_silu_quant, "s8_conv3x3": qc.s8_conv3x3,
            "gn_silu_quant_stream": _Count(qc.gn_silu_quant, "stream_launches"),
            "int8_chain": qc.gn_silu_conv3x3_int8,
            "flash_attention_pv_int8": fa.flash_attention_pv_int8,
            "flash_backward_dq": fa.flash_backward_dq,
            "flash_backward_dkv": fa.flash_backward_dkv,
            "group_norm_fused": gn.group_norm_fused, "group_stats": gn.group_stats,
            "gn_silu_conv3x3_fused": fc.gn_silu_conv3x3_fused,
            "cross_attention": ca.cross_attention}


def _counted_call(models, schedule, ids, shape, kwargs):
    """One ``sample_txt2img`` call with every kernel's count set to 0 just
    before it and read just after: (seconds, launches, images, x0)."""
    import torch

    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img

    counters = _counters()
    torch.cuda.synchronize()
    _reset(counters)
    start = time.perf_counter()
    images, x0 = sample_txt2img(*models, schedule, ids, shape, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return seconds, _read(counters), images, x0


def _set_switches(groupnorm: str, conv: str, cross: bool) -> None:
    from ldm_tf2_tpu_torch.ops.attention import set_packed_cross
    from ldm_tf2_tpu_torch.ops.fused_conv import set_fused_conv_impl
    from ldm_tf2_tpu_torch.ops.group_norm import set_groupnorm_impl

    set_groupnorm_impl(groupnorm)
    set_fused_conv_impl(conv)
    set_packed_cross(cross)


def _opt_in_launches(evals: int, groupnorm: str = "pallas") -> dict:
    """What a sampling call of ``evals`` U-Net evals and one decode launches
    with the three switches on (``groupnorm``: "pallas" or "stats")."""
    count = {k: evals * OPT_EVAL[k] + OPT_DECODE[k] for k in OPT_EVAL}
    gn_name = "group_norm_fused" if groupnorm == "pallas" else "group_stats"
    return {"gn_silu_conv3x3_fused": count["gn_silu_conv3x3_fused"],
            "cross_attention": count["cross_attention"], gn_name: count["group_norm"],
            "flash_attention": 16 * evals + 1, "fused_ffn": 16 * evals}


def phase_opt_in(card: str, run: dict):
    """The main path with the JAX package's three opt-in switches on
    (GroupNorm "pallas", fused conv "pallas", packed cross): 50 DDIM steps,
    batch 2, through ``sample_txt2img``, in turns with the default route
    (default, opt-in, default, opt-in); exact launch counts; latents and
    images against the default route's; every chain and cross-attention
    launch of the counted call on wgmma; each chain weight relaid once, in
    the first call; a profiled window of U-Net evals, its device busy time
    beside the default route's.  Then a 10-step run with GroupNorm "stats",
    against a 10-step default run.  Returns the launches of both opt-in
    runs and the counted call's chain and cross launches by path."""
    import numpy as np

    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.ops import fused_conv as fc

    models, ids, shape, kwargs = run["models"], run["ids"], run["shape"], run["kwargs"]
    schedule = factory.build_schedule(run["config"])
    steps = schedule.num_ddim_steps
    chain = fc.gn_silu_conv3x3_fused
    _set_switches("pallas", "pallas", True)
    try:
        # warm-up: a 2-step run outside the counted, timed ones; the first
        # call relays each chain's weight once, the second none
        chain.relayouts = 0
        _counted_call(models, make_schedule(num_ddim_steps=2), ids, shape, kwargs)
        relayouts = [chain.relayouts]
        chain.relayouts = 0
        seconds, launches, images, x0 = _counted_call(models, schedule, ids, shape, kwargs)
        relayouts.append(chain.relayouts)
        paths = {k: dict(LAST_PATHS[k]) for k in ("gn_silu_conv3x3_fused", "cross_attention")}
        check_no_fma("opt-in main path")
        # every GroupNorm resident but the decoder's last one at 256^2
        gn_modes = dict(LAST_MODES["group_norm_fused"])
        gn_want = launches["group_norm_fused"]
        check(gn_modes == {"resident": gn_want - 1, "reread": 1},
              f"opt-in GroupNorm launches by mode {gn_modes}, expected 1 reread "
              f"({OPT_GN_REREAD}) of {gn_want}")
        _set_switches("auto", "auto", False)
        default_s = _counted_call(models, schedule, ids, shape, kwargs)[0]
        _set_switches("pallas", "pallas", True)
        seconds2 = _counted_call(models, schedule, ids, shape, kwargs)[0]
        images = images.float().cpu().numpy()
        x0 = x0.float().cpu()
        check(bool(np.isfinite(images).all()), "opt-in images are not finite")
        _, rel_x0 = errors(x0, run["x0"])
        img_diff = images - run["images"]
        rel_img = float(np.linalg.norm(img_diff) / np.linalg.norm(run["images"]))
        want = _opt_in_launches(steps)
        got = {k: v for k, v in launches.items() if v or k in want}
        log(f"opt-in main path on {card}: {steps} steps, batch {shape[0]}, 256^2, "
            f"GroupNorm pallas + fused conv pallas + packed cross: {seconds:.3f} s and "
            f"{seconds2:.3f} s per call against the default route's "
            f"{run['seconds']:.3f} s and {default_s:.3f} s (turns: default, opt-in, "
            f"default, opt-in); x0 rel_l2 {rel_x0:.3e}, images rel_l2 {rel_img:.3e} "
            f"against the default route (bound {OPT_ROUTE_TOL:g}); launches {got}; by "
            f"path {paths}; weight relayouts {relayouts[0]} in the first call, "
            f"{relayouts[1]} in the second")
        check(got == want, f"opt-in launch counts {got}, expected {want}")
        check(rel_x0 < OPT_ROUTE_TOL and rel_img < OPT_ROUTE_TOL,
              f"opt-in route x0 {rel_x0:.3e} / images {rel_img:.3e} from the default")
        for k, p in paths.items():  # every bf16 launch on the wgmma path
            check(p == {"wgmma": want[k], "mma.sync": 0, "fma": 0},
                  f"opt-in {k} launches by path {p}, expected {want[k]} on wgmma")
        chains = OPT_EVAL["gn_silu_conv3x3_fused"] + OPT_DECODE["gn_silu_conv3x3_fused"]
        check(relayouts == [chains, 0],
              f"weight relayouts {relayouts}, expected [{chains}, 0] (one per chain weight)")
        profile = phase_profile(models[1], shape, what="opt-in bf16")
        busy = [("not measured" if p is None else
                 f"{p['busy_ms']:.2f} ms in {p['launches']:.0f} launches")
                for p in (profile, run["profile"])]
        log(f"opt-in U-Net eval at CFG batch {2 * shape[0]}: device busy {busy[0]} against "
            f"the default route's {busy[1]}")
        eval_group_norms(models[1], shape)

        # GroupNorm "stats": the stats kernel, the normalize in PyTorch
        short = make_schedule(num_ddim_steps=10)
        _set_switches("auto", "auto", False)
        default_short, _, _, x0_default = _counted_call(models, short, ids, shape, kwargs)
        _set_switches("stats", "pallas", True)
        s_stats, stats_launches, images_s, x0_s = _counted_call(
            models, short, ids, shape, kwargs)
        check(bool(np.isfinite(images_s.float().cpu().numpy()).all()),
              "stats-route images are not finite")
        _, rel_s = errors(x0_s.float().cpu(), x0_default.float().cpu())
        want_s = _opt_in_launches(10, "stats")
        got_s = {k: v for k, v in stats_launches.items() if v or k in want_s}
        log(f"opt-in main path, GroupNorm stats, 10 steps: {s_stats:.3f} s against the "
            f"default route's {default_short:.3f} s; x0 rel_l2 {rel_s:.3e} against the "
            f"default (bound {OPT_ROUTE_TOL:g}); launches {got_s}")
        check(got_s == want_s, f"stats-route launch counts {got_s}, expected {want_s}")
        check(rel_s < OPT_ROUTE_TOL, f"stats route x0 {rel_s:.3e} from the default")
    finally:
        _set_switches("auto", "auto", False)
    return launches, stats_launches, {**paths, "group_norm_fused": gn_modes}


def eval_group_norms(unet, shape) -> None:
    """Row 5 over one opt-in U-Net eval: its GroupNorm calls counted by
    (shape, eps, SiLU) in one eval at the CFG batch of a latent ``shape``
    (the switches on), each count times the kernels phase's device time and
    bound at that shape, into ``EVAL_SUMS``."""
    import collections

    import torch

    from ldm_tf2_tpu_torch.ops import group_norm as gn

    real, seen = gn._launch_fused, collections.Counter()

    def counted(x, gamma, beta, num_groups, eps, activate):
        seen[(tuple(x.shape), eps, activate)] += 1
        return real(x, gamma, beta, num_groups, eps, activate)

    b2 = 2 * shape[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((b2, *shape[1:]), generator=gen, device="cuda", dtype=unet.dtype)
    ctx = torch.randn(b2, 77, 1280, generator=gen, device="cuda", dtype=unet.dtype) * 0.05
    gn._launch_fused = counted  # the kernel's launcher, under group_norm_fused
    try:
        with torch.inference_mode():
            unet(x, torch.full((b2,), 501.0, device="cuda"), ctx)
    finally:
        gn._launch_fused = real
    check(sum(seen.values()) == OPT_EVAL["group_norm"] and all(k in GN_ROWS for k in seen),
          f"one opt-in eval's GroupNorms {dict(seen)}: want {OPT_EVAL['group_norm']} at "
          f"OPT_GN shapes")
    EVAL_SUMS["group_norm_fused"] = sums = {
        k: sum(n * GN_ROWS[key][k] for key, n in seen.items())
        for k in ("device_ms", "library_device_ms", "bound_ms")}
    log(f"group_norm_fused per opt-in U-Net eval at CFG batch {b2} "
        f"({sum(seen.values())} calls by shape {dict(seen)}): device "
        f"{sums['device_ms']:.4f} ms, F.group_norm {sums['library_device_ms']:.4f} ms, bound "
        f"{sums['bound_ms']:.4f} ms")


def phase_samplers(card: str, run: dict):
    """The rest of the sampler menu with the switches on, through
    ``sample_txt2img`` at the north star: PLMS and DPM-Solver++(2M) (karras
    spacing) at 50 steps, DDPM on a 100-step timeline (the north star's has
    1000: 1000 U-Net evals), the progressive DDIM loop's records, and one
    ``serve()`` call with dpm_solver_pp_2m."""
    import io
    import tempfile

    import numpy as np

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img_progressive
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    models, ids, shape, kwargs = run["models"], run["ids"], run["shape"], run["kwargs"]
    ldm = run["config"]["ldm"]
    base = dict(num_steps=ldm["num_steps"], beta_start=ldm["beta_start"],
                beta_end=ldm["beta_end"], num_ddim_steps=ldm["num_ddim_steps"])
    runs = (("plms", make_schedule(**base), "uniform spacing"),
            ("dpm_solver_pp_2m", make_schedule(**base, timestep_spacing="karras"),
             "karras spacing"),
            ("ddpm", make_schedule(**{**base, "num_steps": 100}),
             "T = 100 of the north star's 1000, cut to keep the phase short"))
    _set_switches("pallas", "pallas", True)
    try:
        for sampler, schedule, note in runs:
            evals = schedule.num_steps if sampler == "ddpm" else schedule.num_ddim_steps
            seconds, launches, images, x0 = _counted_call(
                models, schedule, ids, shape, {**kwargs, "sampler": sampler})
            images = images.float().cpu().numpy()
            want = _opt_in_launches(evals)
            got = {k: v for k, v in launches.items() if v or k in want}
            finite = bool(np.isfinite(images).all()) and images.shape == (2, 256, 256, 3)
            log(f"sampler {sampler} on {card} ({note}), batch {shape[0]}, switches on: "
                f"{seconds:.3f} s per call ({evals} U-Net evals), images finite "
                f"{finite}; launches {got}")
            check(finite, f"{sampler}: images not finite or misshapen")
            check(got == want, f"{sampler} launch counts {got}, expected {want}")

        schedule = factory.build_schedule(run["config"])
        start = time.perf_counter()
        images, _, sample_prog, pred_x0_prog = sample_txt2img_progressive(
            *models, schedule, ids, shape, **kwargs)
        seconds = time.perf_counter() - start
        want_shape = (2, 10, 256, 256, 3)
        ok = (tuple(sample_prog.shape) == want_shape
              and tuple(pred_x0_prog.shape) == want_shape
              and all(bool(t.float().isfinite().all())
                      for t in (images, sample_prog, pred_x0_prog)))
        log(f"progressive DDIM, 50 steps, every 5th recorded: {seconds:.3f} s; records "
            f"{tuple(sample_prog.shape)} and {tuple(pred_x0_prog.shape)}, finite "
            f"{'PASS' if ok else 'FAIL'}")
        check(ok, "progressive records misshapen or not finite")

        config = json.loads(json.dumps(NORTH_STAR))
        config["ldm_sampling"].update(
            sampler="dpm_solver_pp_2m", vocab_dir=os.path.join(ROOT, "bert_model"))
        config = validate(config)
        out = io.StringIO()
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            start = time.perf_counter()
            serve_ldm.serve(config, io.StringIO(json.dumps(
                {"prompt": "a lighthouse at dusk", "seed": 3, "out": "d"})), out,
                output_dir=out_dir, device="cuda", models=models)
            seconds = time.perf_counter() - start
            resp = json.loads(out.getvalue().splitlines()[0])
            ok = resp["ok"] and np.load(resp["out"]).shape == (2, 256, 256, 3)
        log(f"serve with dpm_solver_pp_2m, switches on: warm-up and one request in "
            f"{seconds:.3f} s, the request {resp.get('latency_s')} s "
            f"{'PASS' if ok else 'FAIL'}")
        check(ok, f"serve with dpm_solver_pp_2m: {resp}")
    finally:
        _set_switches("auto", "auto", False)


def eval_counts(unet, batch2: int, side: int, cache_levels: int | None = None) -> dict:
    """What one U-Net eval dispatches at CFG batch ``batch2`` and latent
    side ``side`` (the shallow pass of ``cache_levels`` levels when given),
    read off the model's blocks: its self-attentions (FFNs), those of 1024
    or more tokens (int8 P.V in that mode), and its ResBlock chains that
    the int8 gate (``use_int8_conv``) claims, of which those where the JAX
    package runs its whole-chain kernel (row 10)."""
    from ldm_tf2_tpu_torch.ops.flash_attention import PV_INT8_MIN_TOKENS
    from ldm_tf2_tpu_torch.ops.quant_conv import use_fused_int8_chain, use_int8_conv

    levels, per = len(unet.channel_mult), unet.num_blocks + 1
    blocks = []  # (block, spatial side)
    n_in = cache_levels * per - 1 if cache_levels else unet.num_input_blocks
    for i in range(n_in):
        block = getattr(unet, f"input_block_{i}")
        if not block.use_downsample:
            blocks.append((block, side >> (i // per)))
    if not cache_levels:
        blocks.append((unet.middle_block, side >> (levels - 1)))
    first = (levels - cache_levels) * per if cache_levels else 0
    for i in range(first, unet.num_output_blocks):
        blocks.append((getattr(unet, f"output_block_{i}"), side >> (levels - 1 - i // per)))
    count = dict.fromkeys(("self_attentions", "pv_int8", "int8_chains",
                           "whole_chains"), 0)
    for block, s in blocks:
        residuals = ((block.residual1, block.residual2) if block is unet.middle_block
                     else (block.residual,))
        if block.spatial_transformer is not None:
            count["self_attentions"] += 1
            count["pv_int8"] += s * s >= PV_INT8_MIN_TOKENS
        for res in residuals:
            for conv, has_add in ((res.conv2d_1, False), (res.conv2d_2, True)):
                cout, cin = conv.kernel.shape[:2]
                if use_int8_conv((batch2, s, s, cin), cout, has_add=has_add):
                    count["int8_chains"] += 1
                    count["whole_chains"] += use_fused_int8_chain(s * s, s, cin, cout,
                                                                  has_add)
    count["ffn"] = count["self_attentions"]
    return count


def _deepcache_evals(steps: int, interval: int) -> tuple[int, int]:
    """(full, shallow) U-Net evals of a DeepCache loop of ``steps`` steps:
    a full eval every ``interval``-th step, the first included."""
    full = -(-steps // interval)
    return full, steps - full


def phase_deepcache_img2img(card: str, run: dict):
    """DeepCache, img2img and inpainting at the north star (256^2, batch 2,
    bf16, default route), through the entry points: a full-width U-Net's
    shallow pass fed a fresh cache against its full pass (cache_levels 1 and
    3) and one profiled shallow eval; ``sample_txt2img`` with DDIM DeepCache
    (50 steps, interval 3, one level), with interval 1 against the main
    path's plain DDIM images, and with DPM-Solver++(2M) DeepCache (20
    karras steps, interval 2, two levels); ``sample_img2img`` at strength
    0.75 from a seeded uint8 image read by the CLI's loader, then with a
    mask that keeps the left half; one ``serve()`` request with
    cache_interval 3; one DDIM DeepCache call in the int8 serving modes at
    batch 4.  Each call's launches are counted around it and held to what
    its evals dispatch (``eval_counts``); DeepCache and plain DDIM are then
    timed in turns."""
    import io
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import (
        load_init_image, load_mask, sample_img2img, sample_txt2img,
    )
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    models, ids, shape, kwargs = run["models"], run["ids"], run["shape"], run["kwargs"]
    unet, autoencoder = models[1], models[2]
    config = run["config"]
    schedule = factory.build_schedule(config)
    steps = schedule.num_ddim_steps
    counters = _counters()
    b2, side = 2 * shape[0], shape[1]

    def counted(fn, *args, **kw):
        torch.cuda.synchronize()
        _reset(counters)
        start = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - start, _read(counters), out

    def want_of(full: int, shallow: int, levels: int, encodes: int = 0) -> dict:
        """A bf16 call's launches: its full and shallow evals, the decoder's
        mid-block attention and ``encodes`` encoder ones."""
        per = eval_counts(unet, b2, side, levels)
        want = dict.fromkeys(counters, 0)
        want.update(flash_attention=16 * full + per["self_attentions"] * shallow
                    + 1 + encodes,
                    fused_ffn=16 * full + per["ffn"] * shallow)
        return want

    # a full-width U-Net's shallow pass against its full pass
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b2, *shape[1:]), generator=gen, device="cuda", dtype=unet.dtype)
    t = torch.full((b2,), 501.0, device="cuda")
    ctx = torch.randn(b2, 77, 1280, generator=gen, device="cuda", dtype=unet.dtype) * 0.05
    with torch.inference_mode():
        full = unet(x, t, ctx)
        for levels in (1, 3):
            out, cache = unet(x, t, ctx, return_cache=True, cache_levels=levels)
            shallow = unet(x, t, ctx, shallow_cache=cache, cache_levels=levels)
            rel = errors(shallow, full)[1]
            rel_out = errors(out, full)[1]
            log(f"deepcache: full-width U-Net at CFG batch {b2}, cache_levels {levels}: "
                f"cache {tuple(cache.shape)}; shallow vs full rel_l2 {rel:.3e} "
                f"(bound {DEEPCACHE_TOL:g}), bit-equal {torch.equal(shallow, full)}; "
                f"cache-returning pass vs full rel_l2 {rel_out:.3e}, bit-equal "
                f"{torch.equal(out, full)}")
            check(rel <= DEEPCACHE_TOL and rel_out <= DEEPCACHE_TOL,
                  f"shallow pass at cache_levels {levels}: rel_l2 {rel:.3e}, "
                  f"cache-returning pass {rel_out:.3e}")
    shallow_profile = phase_profile(unet, shape, cache_levels=1)
    busy = [("not measured" if p is None else
             f"{p['busy_ms']:.2f} ms in {p['launches']:.0f} launches")
            for p in (shallow_profile, run["profile"])]
    log(f"deepcache: one shallow eval (cache_levels 1) at CFG batch {b2}: device busy "
        f"{busy[0]} against a full eval's {busy[1]}")

    # DDIM DeepCache, interval 3, one level; interval 1 against plain DDIM
    sample_txt2img(*models, make_schedule(num_ddim_steps=2), ids, shape,
                   cache_interval=2, **kwargs)  # warm-up
    nf, ns = _deepcache_evals(steps, 3)
    seconds, launches, (images, _) = counted(
        sample_txt2img, *models, schedule, ids, shape, cache_interval=3,
        cache_levels=1, **kwargs)
    want = want_of(nf, ns, 1)
    finite = bool(images.float().isfinite().all())
    log(f"deepcache DDIM on {card}: {steps} steps, interval 3, cache_levels 1, batch "
        f"{shape[0]}: {seconds:.3f} s per call ({nf} full, {ns} shallow evals); images "
        f"finite {finite}; launches {launches}")
    check(finite, "deepcache DDIM images not finite")
    check(launches == want, f"deepcache DDIM launch counts {launches}, expected {want}")
    check_no_fma("deepcache DDIM")
    flash_paths = dict(LAST_PATHS["flash_attention"])
    check(flash_paths["wgmma"] == want["flash_attention"],
          f"deepcache DDIM flash launches by path {flash_paths}: want all on wgmma")
    seconds1, launches1, (images1, _) = counted(
        sample_txt2img, *models, schedule, ids, shape, cache_interval=1, **kwargs)
    images1 = images1.float().cpu().numpy()
    rel1 = float(np.linalg.norm(images1 - run["images"]) / np.linalg.norm(run["images"]))
    equal1 = bool(np.array_equal(images1, run["images"]))
    log(f"deepcache DDIM, interval 1: {seconds1:.3f} s; images vs the main path's plain "
        f"DDIM (same seed) rel_l2 {rel1:.3e} (bound {DEEPCACHE_TOL:g}), bit-equal "
        f"{equal1}; launches {launches1['flash_attention']} flash, "
        f"{launches1['fused_ffn']} FFN")
    check(rel1 <= DEEPCACHE_TOL, f"deepcache interval 1 vs plain DDIM rel_l2 {rel1:.3e}")
    # the host's wall moves between calls: DeepCache and plain DDIM in turns
    turns = [seconds, seconds1]
    for interval in (3, 1):
        turns.append(counted(sample_txt2img, *models, schedule, ids, shape,
                             cache_interval=interval, **kwargs)[0])
    log(f"deepcache DDIM on {card}, seconds per call in turns (interval 3, plain, "
        f"interval 3, plain): {', '.join(f'{t:.3f}' for t in turns)}; plain / DeepCache "
        f"{(turns[1] + turns[3]) / (turns[0] + turns[2]):.2f}x")

    # DPM-Solver++(2M) DeepCache, 20 karras steps, interval 2, two levels
    ldm = config["ldm"]
    dpm = make_schedule(num_steps=ldm["num_steps"], beta_start=ldm["beta_start"],
                        beta_end=ldm["beta_end"], num_ddim_steps=20,
                        timestep_spacing="karras")
    nf, ns = _deepcache_evals(20, 2)
    seconds, launches, (images, _) = counted(
        sample_txt2img, *models, dpm, ids, shape, sampler="dpm_solver_pp_2m",
        cache_interval=2, cache_levels=2, **kwargs)
    want = want_of(nf, ns, 2)
    finite = bool(images.float().isfinite().all())
    log(f"deepcache DPM-Solver++(2M) on {card}: 20 karras steps, interval 2, "
        f"cache_levels 2: {seconds:.3f} s per call ({nf} full, {ns} shallow evals); "
        f"images finite {finite}; launches {launches}")
    check(finite, "deepcache DPM images not finite")
    check(launches == want, f"deepcache DPM launch counts {launches}, expected {want}")
    check_no_fma("deepcache DPM")

    # img2img and inpainting, strength 0.75 of the 50-step schedule, KL
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        pixels = np.random.default_rng(11).integers(0, 256, (2, 256, 256, 3), np.uint8)
        np.save(os.path.join(tmp, "init.npy"), pixels)
        keep_left = np.ones((256, 256), np.float32)
        keep_left[:, :128] = 0.0  # 1 = regenerate, 0 = keep
        np.save(os.path.join(tmp, "mask.npy"), keep_left)
        init_image = load_init_image(os.path.join(tmp, "init.npy"), config)
        mask = torch.as_tensor(load_mask(os.path.join(tmp, "mask.npy"), shape),
                               device="cuda")
    t_enc = int(round(0.75 * steps))
    i2i = {k: kwargs[k] for k in ("guidance_scale", "scale_factor", "seed", "device")}
    with torch.inference_mode():
        _, enc_launches, _ = counted(
            autoencoder.encode, torch.as_tensor(init_image, device="cuda"))
    enc_paths = dict(LAST_PATHS["flash_attention"])
    log(f"img2img: the KL encoder's mid-block attention [{shape[0]}, 1024, 1, 512]: "
        f"{enc_launches['flash_attention']} flash launch, by path {enc_paths}")
    check(enc_launches["flash_attention"] == 1 and enc_paths["wgmma"] == 1,
          f"encoder flash launches {enc_launches['flash_attention']} by path {enc_paths}")
    want = want_of(t_enc, 0, 1, encodes=1)
    results = {}
    for name, m in (("img2img", None), ("inpainting", mask)):
        seconds, launches, (images, x0, init_latent) = counted(
            sample_img2img, *models, schedule, ids, init_image, mask=m, strength=0.75,
            **i2i)
        finite = bool(images.float().isfinite().all()) and tuple(images.shape) == (
            2, 256, 256, 3)
        log(f"{name} on {card}: strength 0.75, t_enc {t_enc} of {steps} steps, batch "
            f"{shape[0]}: {seconds:.3f} s per call; images finite {finite}; launches "
            f"{launches}")
        check(finite, f"{name} images not finite or misshapen")
        check(launches == want, f"{name} launch counts {launches}, expected {want}")
        check_no_fma(name)
        results[name] = (x0, init_latent)
    x0, init_latent = results["inpainting"]
    kept = torch.equal(x0[:, :, :16], init_latent[:, :, :16])
    moved = float((x0[:, :, 16:].float() - init_latent[:, :, 16:].float()).abs().max())
    log(f"inpainting: kept left half of x0 equal to the init latent {kept}; the "
        f"regenerated half moved by max |d| {moved:.3f} (want > 0.1)")
    check(kept and moved > 0.1, f"inpainting kept region equal {kept}, moved {moved}")

    # the server with DeepCache: the warm-up call and one request
    serve_config = json.loads(json.dumps(NORTH_STAR))
    serve_config["ldm_sampling"].update(cache_interval=3,
                                        vocab_dir=os.path.join(ROOT, "bert_model"))
    serve_config = validate(serve_config)
    out = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        seconds, launches, _ = counted(
            serve_ldm.serve, serve_config, io.StringIO(json.dumps(
                {"prompt": "a lighthouse at dusk", "seed": 3, "out": "c"})), out,
            output_dir=out_dir, device="cuda", models=models)
        resp = json.loads(out.getvalue().splitlines()[0])
        ok = resp["ok"] and np.load(resp["out"]).shape == (2, 256, 256, 3)
    nf, ns = _deepcache_evals(steps, 3)
    want = {k: 2 * v for k, v in want_of(nf, ns, 1).items()}
    log(f"serve with cache_interval 3: warm-up and one request in {seconds:.3f} s, the "
        f"request {resp.get('latency_s')} s {'PASS' if ok else 'FAIL'}; launches over 2 "
        f"calls {launches}")
    check(ok, f"serve with DeepCache: {resp}")
    check(launches == want, f"serve DeepCache launch counts {launches}, expected {want}")

    # DDIM DeepCache in the int8 serving modes at batch 4 (CFG 8)
    int8_config = json.loads(json.dumps(serve_config))
    int8_config["tpu"].update(quantize="int8", quantize_attention="int8pv")
    shape4 = (4, *shape[1:])
    ids4 = torch.as_tensor(cfg_token_ids(load_tokenizer(os.path.join(ROOT, "bert_model")),
                                         NORTH_STAR["ldm_sampling"]["text_prompt"], 4, 77))
    full8 = eval_counts(unet, 8, side)
    check(full8 == SERVE_EVAL,
          f"eval_counts of a full serve eval {full8}, SERVE_EVAL says {SERVE_EVAL}")
    sh8 = eval_counts(unet, 8, side, 1)
    factory.apply_serving_modes(int8_config, unet, autoencoder)
    try:
        sample_txt2img(*models, make_schedule(num_ddim_steps=2), ids4, shape4,
                       cache_interval=2, **kwargs)  # warm-up
        seconds, launches, (images, _) = counted(
            sample_txt2img, *models, schedule, ids4, shape4, cache_interval=3,
            cache_levels=1, **kwargs)
    finally:
        factory.apply_serving_modes(config, unet, autoencoder)
    evals = dict(zip(("full", "shallow"), _deepcache_evals(steps, 3)))
    per = {k: evals["full"] * full8[k] + evals["shallow"] * sh8[k] for k in full8}
    want = dict.fromkeys(counters, 0)
    want.update(gn_silu_quant=per["int8_chains"], s8_conv3x3=per["int8_chains"],
                int8_chain=per["whole_chains"],
                flash_attention_pv_int8=per["pv_int8"] + 1,
                flash_attention=per["self_attentions"] - per["pv_int8"],
                fused_ffn=per["ffn"])
    finite = bool(images.float().isfinite().all())
    log(f"deepcache DDIM, int8 + int8-P.V, batch 4 on {card}: {seconds:.3f} s per call "
        f"({evals['full']} full, {evals['shallow']} shallow evals; a shallow eval's "
        f"{sh8['int8_chains']} int8 chains, {sh8['whole_chains']} whole, "
        f"{sh8['pv_int8']} int8-P.V); images finite {finite}; rows 8, 11, 13: "
        f"{launches['gn_silu_quant']}, {launches['s8_conv3x3']}, "
        f"{launches['flash_attention_pv_int8']}; launches {launches}")
    check(finite, "int8 deepcache images not finite")
    check(launches == want, f"int8 deepcache launch counts {launches}, expected {want}")
    check(min(launches[k] for k in ("gn_silu_quant", "s8_conv3x3",
                                    "flash_attention_pv_int8")) > 0,
          "int8 deepcache: rows 8, 11 or 13 not launched")
    check_no_fma("int8 deepcache")


# The convert / export / eval phase's checks: the VGG and Inception
# features on the card (float32, TF32 off, cuDNN) against the CPU's, as
# rel L2; measured 1e-6 or below on CPU/CPU orderings, so 1e-4 leaves room
# for the card's summation order while a wrong layer moves them by ~1
FEATURES_TOL = 1e-4
FID_SELF_TOL = 1e-6  # FID of a set against itself


def _fabricate_compvis(manifest: dict, seed: int):
    """A CompVis ``state_dict`` at the key manifest's full width: every
    model key N(0, 1) * 0.05 drawn on the card from one seeded generator in
    the manifest's order (``factory.randomize_``'s convention), as views of
    one host tensor; every ignored key (schedule buffers, EMA shadows) at
    its shape, zeros viewed from one shared buffer, so the file holds their
    bytes once."""
    import torch

    keys = manifest["model_keys"]
    sizes = [max(1, int(torch.Size(shape).numel())) for shape in keys.values()]
    flat = torch.empty(sum(sizes), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    offset = 0
    for size in sizes:
        flat[offset:offset + size].normal_(generator=gen).mul_(0.05)
        offset += size
    host = flat.cpu()
    del flat
    sd, offset = {}, 0
    for (key, shape), size in zip(keys.items(), sizes):
        sd[key] = host[offset:offset + size].view(shape)
        offset += size
    ignored = manifest["ignored_keys"]
    zeros = torch.zeros(max(int(torch.Size(s).numel()) for s in ignored.values()))
    for key, shape in ignored.items():
        sd[key] = zeros[:int(torch.Size(shape).numel())].view(shape)
    return sd, int(host.numel())


def phase_convert_export_eval(card: str) -> dict:
    """The chain from a full-width CompVis checkpoint to a scored sample,
    through the port's entry points: (a) a checkpoint with every key of
    ``tests/goldens/compvis_key_manifest.json`` (seeded weights) saved with
    ``torch.save``, ``cli/convert_ckpt_pytorch`` with ``--validate_only``,
    then its ``convert_checkpoint`` from the file into one blob; (b)
    ``cli/run_ldm_sampler.main`` on that blob, 50 CFG DDIM steps at the
    north star, its launches counted around it (rows 1 and 2 at the main
    path's counts, every bf16 launch on wgmma), the images bit-equal to
    sampling with the trees the conversion returned loaded in memory;
    (c) ``cli/export_pretrained --which serving --dtype bfloat16`` and the
    sampler on the bf16 blob with ``tpu.weights_dtype`` null, bit-equal to
    (b) (float32 blob, ``weights_dtype: bfloat16``), each blob's size and
    read time; (d) ``cli/run_eval.evaluate``: the VGG-FID of (b)'s images
    against a second seeded batch (seeded LPIPS weights from an ``lpips``
    blob), the VGG and synthetic-weight Inception pool3 features card vs
    CPU, FID of a set against itself, and each extractor's img/s.
    Returns the sampler call's launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.checkpoints.blob import export_blob, read_blob
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, params_to_jax
    from ldm_tf2_tpu_torch.cli import convert_ckpt_pytorch as convert_cli
    from ldm_tf2_tpu_torch.cli import export_pretrained, run_eval, run_ldm_sampler
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.eval import fid, inception

    phase_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="convert_phase_")
    free_gb = shutil.disk_usage(work).free / 1e9
    log(f"convert: work dir {work}, {free_gb:.1f} GB free")
    raw = json.loads(json.dumps(NORTH_STAR))
    raw["ldm_sampling"]["vocab_dir"] = os.path.join(ROOT, "bert_model")
    config_path = os.path.join(work, "north_star.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)
    null_weights = json.loads(json.dumps(raw))
    null_weights["tpu"]["weights_dtype"] = None
    null_config_path = os.path.join(work, "north_star_f32_weights.yaml")
    with open(null_config_path, "w") as f:
        yaml.safe_dump(null_weights, f)
    config = validate(json.loads(json.dumps(raw)))
    cwd = os.getcwd()
    try:
        # (a) the checkpoint, validated and converted by the CLI
        with open(convert_cli.default_manifest_path()) as f:
            manifest = json.load(f)
        start = time.perf_counter()
        sd, n_params = _fabricate_compvis(manifest, seed=31)
        check(n_params == manifest["total_model_params"],
              f"fabricated {n_params} params, manifest {manifest['total_model_params']}")
        ckpt = os.path.join(work, "txt2img-f8-large.ckpt")
        fabricate_s = time.perf_counter() - start
        torch.save({"state_dict": sd}, ckpt)
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        save_s = time.perf_counter() - start - fabricate_s
        log(f"convert: fabricated {n_params:,} model params + "
            f"{len(manifest['ignored_keys'])} ignored keys in {fabricate_s:.1f} s, "
            f"saved {ckpt_gb:.2f} GB in {save_s:.1f} s")
        start = time.perf_counter()
        rc = convert_cli.main(["--pytorch_ckpt_path", ckpt, "--validate_only"])
        validate_s = time.perf_counter() - start
        check(rc == 0, f"--validate_only said no-go (rc {rc})")
        del sd
        start = time.perf_counter()
        trees = convert_cli.convert_checkpoint(ckpt, config, os.path.join(work, "f32"))
        convert_s = time.perf_counter() - start
        os.remove(ckpt)
        f32_blob = os.path.join(work, "f32", "params")
        f32_gb = os.path.getsize(f32_blob + ".bin") / 1e9
        log(f"convert on {card}: --validate_only {validate_s:.1f} s (GO); conversion "
            f"(load, convert, verify against the port's models, write the blob and "
            f"the checksum manifest) {convert_s:.1f} s, blob {f32_gb:.3f} GB, "
            f"{f32_gb / convert_s:.2f} GB/s")

        # (b) the sampler CLI on the blob, counted
        counters = _counters()
        os.chdir(work)
        torch.cuda.synchronize()
        _reset(counters)
        start = time.perf_counter()
        images = run_ldm_sampler.main(["--config_path", config_path,
                                       "--params_blob", f32_blob, "--seed", "0"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
        launches = _read(counters)
        steps = config["ldm"]["num_ddim_steps"]
        want = {k: 0 for k in launches}
        want.update({"flash_attention": 16 * steps + 1, "fused_ffn": 16 * steps})
        check(launches == want, f"sampler CLI launches {launches}, expected {want}")
        check_no_fma("convert: sampler CLI")
        saved = np.load(os.path.join(work, "images.npy"))
        check(saved.shape == (2, 256, 256, 3) and saved.dtype == np.uint8,
              f"images.npy {saved.shape} {saved.dtype}")
        check(bool(torch.isfinite(images).all()), "sampled images are not finite")
        log(f"convert: sampler CLI on the blob {cli_s:.3f} s (blob read, models "
            f"built and loaded, {steps} steps, decode); launches {launches}")

        start = time.perf_counter()
        models = [load_params(build(config, device="cuda"), trees[name]) for build, name in (
            (factory.build_cond_model, "cond_stage_model"), (factory.build_unet, "unet"),
            (factory.build_autoencoder, "autoencoder"))]
        del trees
        torch.cuda.synchronize()
        log(f"convert: the converted trees built and loaded in memory "
            f"{time.perf_counter() - start:.1f} s")
        sampling = config["ldm_sampling"]
        shape = tuple(sampling["latent_shape"])
        ids = torch.as_tensor(cfg_token_ids(
            load_tokenizer(sampling["vocab_dir"]), sampling["text_prompt"], shape[0],
            config["cond_stage_model"]["max_seq_len"]), dtype=torch.long)
        kwargs = dict(guidance_scale=float(sampling["guidance_scale"]),
                      guidance_rescale=float(sampling["guidance_rescale"]),
                      scale_factor=config["ldm"]["scale_factor"], device="cuda")
        schedule = factory.build_schedule(config)
        in_memory, _ = sample_txt2img(*models, schedule, ids, shape, seed=0, **kwargs)
        check(torch.equal(images, in_memory),
              f"blob vs in-memory: {errors(images, in_memory)} (max abs, rel L2)")
        log("convert: sampling from the blob is bit-equal to the converted trees "
            "loaded in memory")

        # (c) the bf16 serving blob
        start = time.perf_counter()
        export_pretrained.main(["--config_path", config_path, "--which", "serving",
                                "--params_blob", f32_blob, "--dtype", "bfloat16",
                                "--out_dir", os.path.join(work, "bf16")])
        export_s = time.perf_counter() - start
        bf16_blob = os.path.join(work, "bf16", "params")
        bf16_gb = os.path.getsize(bf16_blob + ".bin") / 1e9
        reads = {}
        for name, path, gb in (("float32", f32_blob, f32_gb), ("bf16", bf16_blob, bf16_gb)):
            start = time.perf_counter()
            read_blob(path)
            reads[name] = time.perf_counter() - start
            log(f"convert on {card}: {name} blob {gb:.3f} GB read in {reads[name]:.2f} s, "
                f"{gb / reads[name]:.2f} GB/s")
        log(f"convert: export --which serving --dtype bfloat16 {export_s:.1f} s "
            f"({f32_gb:.3f} -> {bf16_gb:.3f} GB)")
        _reset(counters)
        from_bf16 = run_ldm_sampler.main(["--config_path", null_config_path,
                                          "--params_blob", bf16_blob, "--seed", "0"])
        torch.cuda.synchronize()
        bf16_launches = _read(counters)
        check(bf16_launches == want, f"bf16 blob launches {bf16_launches}, expected {want}")
        check_no_fma("convert: sampler CLI on the bf16 blob")
        check(torch.equal(from_bf16, images),
              f"bf16 blob vs float32 blob with weights_dtype bfloat16: "
              f"{errors(from_bf16, images)}")
        log("convert: the bf16 blob (weights_dtype null) samples bit-equal to the "
            "float32 blob with tpu.weights_dtype: bfloat16")

        # (d) the score
        lpips = factory.randomize_(factory.build_lpips(config, "cuda").float(), 41)
        lpips_blob = os.path.join(work, "lpips")
        export_blob(lpips_blob, {"lpips": params_to_jax(lpips)})
        del lpips
        lpips_state = read_blob(lpips_blob)["lpips"]
        second, _ = sample_txt2img(*models, schedule, ids, shape, seed=1, **kwargs)
        generated = images.float().cpu().numpy()
        real = second.float().cpu().numpy()
        start = time.perf_counter()
        result = run_eval.evaluate(generated, real, "vgg", lpips_state, device="cuda")
        log(f"convert: run_eval {json.dumps(result)} ({time.perf_counter() - start:.2f} s)")
        check(result["num_generated"] == 2 and np.isfinite(result["fid"]),
              f"run_eval result {result}")
        both = np.concatenate([generated, real])
        vgg_card = fid.vgg_feature_extractor(lpips_state, "cuda")
        on_card = vgg_card(both)
        on_cpu = fid.vgg_feature_extractor(lpips_state, "cpu")(both)
        _, vgg_rel = errors(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
        self_fid = fid.fid_from_features(on_card, on_card)
        check(vgg_rel < FEATURES_TOL, f"VGG features card vs CPU rel L2 {vgg_rel:.3e}")
        check(self_fid < FID_SELF_TOL, f"FID of a set against itself {self_fid:.3e}")
        sd_inc = inception.make_synthetic_inception_state_dict(seed=3)
        inc_card = inception.extractor_from_state_dict(sd_inc, device="cuda")
        inc_on_card = inc_card(both)
        inc_on_cpu = inception.extractor_from_state_dict(sd_inc, device="cpu")(both)
        _, inc_rel = errors(torch.from_numpy(inc_on_card), torch.from_numpy(inc_on_cpu))
        check(inc_rel < FEATURES_TOL, f"Inception pool3 card vs CPU rel L2 {inc_rel:.3e}")
        check(fid.fid_from_features(inc_on_card, inc_on_card) < FID_SELF_TOL,
              "Inception FID of a set against itself")
        batch = np.random.default_rng(0).uniform(-1, 1, (32, 256, 256, 3)).astype(np.float32)
        rates = {}
        for name, extract in (("VGG", vgg_card), ("Inception", inc_card)):
            extract(batch[:16])
            torch.cuda.synchronize()
            start = time.perf_counter()
            extract(batch)
            torch.cuda.synchronize()
            rates[name] = len(batch) / (time.perf_counter() - start)
        log(f"convert on {card}: VGG features card vs CPU rel L2 {vgg_rel:.3e}, Inception "
            f"pool3 {inc_rel:.3e} (bound {FEATURES_TOL:g}); FID(x, x) {self_fid:.3e}; "
            f"extractors at 256^2, batch 16, float32: VGG {rates['VGG']:.1f} img/s, "
            f"Inception (resize to 299 included) {rates['Inception']:.1f} img/s")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log(f"convert: phase {time.perf_counter() - phase_start:.1f} s")
    return launches


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
                "int8_chain": steps * ev["whole_chains"],
                "flash_attention_pv_int8": steps * ev["pv_int8"] + 1,
                "flash_attention": steps * (ev["self_attentions"] - ev["pv_int8"]),
                "fused_ffn": steps * ev["ffn"]}
    calls = 3  # warm-up, seed 1 (4 slots), seed 2 (1 slot, 3 padded)
    want = {k: 0 for k in _counters()}  # the opt-in switches are off
    want.update({k: calls * v for k, v in per_call.items()})

    requests = "\n".join([
        json.dumps({"prompt": "a virus monster is playing guitar", "n": 2,
                    "seed": 1, "guidance_scale": 5.0, "out": "s1"}),
        json.dumps({"prompt": ["an oil painting of a harbour", "a red fox"],
                    "seed": 1, "guidance_scale": 7.5, "out": "s2"}),
        json.dumps({"prompt": "a lighthouse at dusk", "n": 1, "seed": 2,
                    "out": "s3"}),
        "this is not json",
    ])
    counters = _counters()
    out = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        start = time.perf_counter()
        serve_ldm.serve(config, io.StringIO(requests), out, output_dir=out_dir,
                        device="cuda", models=models)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = _read(counters)
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
    check_no_fma("serve")
    gnq = LAST_MODES["gn_silu_quant"]
    check(gnq == {"resident": want["gn_silu_quant"], "reread": 0},
          f"serve: GN+SiLU+quantize launches by mode {gnq}, want all resident")
    pv8 = LAST_PATHS["flash_attention_pv_int8"]
    check(pv8 == {**dict.fromkeys(pv8, 0), "wgmma": want["flash_attention_pv_int8"]},
          f"serve: int8-P.V launches by path {pv8}, want all "
          f"{want['flash_attention_pv_int8']} on wgmma")
    phase_profile(models[1], (4, 32, 32, 4))  # the U-Net in its int8 modes
    return launches


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_bwd" in low:
        return "flash backward kernels"
    if "flash_fwd" in low:
        return "flash_attention kernel"
    if "pv_int8" in low or "v_quant" in low:
        return "flash_attention_pv_int8 kernels"
    if "s8_conv" in low or "s8_splitk" in low:
        return "s8_conv3x3 kernels"
    if any(k in low for k in ("conv_wgmma", "conv_mma", "conv_fma", "splitk_epilogue")):
        return "gn_silu_conv3x3 kernels"
    if any(k in low for k in ("cross_wgmma", "cross_mma", "cross_fma")):
        return "cross_attention kernel"
    if any(k in low for k in ("gn_channel_stats", "gn_normalize", "gn_cluster_norm")):
        return "GroupNorm stats / normalize kernels"
    if "gn_silu_quant" in low:
        return "gn_silu_quant kernel"
    if "ffn_" in low:
        return "fused_ffn kernels"
    if "fprop" in low or "conv" in low or "dgrad" in low:
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS)"
    return "elementwise / norm / copy"


def _train_config(batch: int, size: int, **training) -> dict:
    """The stage-2 trainer's config at the north star: bf16 compute over
    float32 U-Net masters, frozen models in bf16, EMA on, in-memory data."""
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(NORTH_STAR))
    config["tpu"] = dict(compute_dtype="bfloat16", frozen_weights_dtype="bfloat16",
                         log_per_iterations=1)
    config["ldm_training"] = dict(
        root_path=None, params=dict(batch_size=batch, image_size=size),
        autoencoder_type="kl", ckpt_path=None, num_iterations=2,
        train_cond_model=False, condition_dropout_rate=0.1, ema_decay=0.9999)
    config["ldm_training"].update(training)
    config["latent_diffusion_optimizer"] = dict(learning_rate=5e-5)
    return validate(config)


def _train_models(config, device):
    """(text encoder, U-Net, KL autoencoder) at the north star from fixed
    seeds: the same weights in every process."""
    from ldm_tf2_tpu_torch import factory

    return (
        factory.randomize_(factory.build_cond_model(config, device, "frozen_weights_dtype"), 51),
        factory.build_trainable_unet(config, device, seed=52),
        factory.randomize_(factory.build_autoencoder(config, "kl", device,
                                                     "frozen_weights_dtype"), 53),
    )


def phase_train(card: str):
    """The stage-2 trainer at the north star through ``train()``: 2 warm-up
    steps, 5 timed steps with the launch counts read around them, 2 steps
    under the profiler; each call starts from a fresh optimizer state and
    goes on training the same U-Net."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train

    batch, size = 8, 256
    config = _train_config(batch, size)
    start = time.perf_counter()
    models = _train_models(config, "cuda")
    frozen = [p.detach().clone() for m in (models[0], models[2]) for p in m.parameters()]
    unet0 = [p.detach().clone() for p in models[1].parameters()]
    torch.cuda.synchronize()
    log(f"train: built the models (U-Net "
        f"{sum(p.numel() for p in models[1].parameters()) / 1e9:.3f} B float32 params) "
        f"in {time.perf_counter() - start:.1f} s")
    rng = np.random.default_rng(54)

    def batches(n):
        for _ in range(n):
            ids = rng.integers(1000, 30000, (batch, 77))
            ids[:, 0], ids[:, 20], ids[:, 21:] = 101, 102, 0
            yield (rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32), ids)

    def run(steps):
        config["ldm_training"]["num_iterations"] = steps
        data = list(batches(steps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, records = train(config, device="cuda", seed=55, batches=data, models=models)
        torch.cuda.synchronize()
        return records, time.perf_counter() - t0

    warm, _ = run(2)
    counters = _counters()
    steps = 5
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    records, seconds = run(steps)
    launches = _read(counters)
    check_no_fma(f"train, {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_records, prof_seconds = run(2)
    losses = [r["loss"] for r in warm + records + prof_records]
    check(all(np.isfinite(losses)), f"train losses {losses}")
    step_s = [b["time"] - a["time"] for a, b in zip(records, records[1:])]
    s_per_step = statistics.median(step_s)
    log(f"train on {card}: batch {batch}, {size}^2, bf16 compute, float32 U-Net masters, "
        f"{steps} steps in {seconds:.3f} s (optimizer state and first step included); "
        f"steps 2-{steps}: {s_per_step:.4f} s/step median "
        f"({', '.join(f'{x:.4f}' for x in step_s)}), {batch / s_per_step:.3f} img/s; "
        f"peak memory {peak_gb:.2f} GB; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"launches over {steps} steps {launches}")
    want = {k: steps * v for k, v in TRAIN_STEP.items()}
    check(launches == want, f"train launch counts {launches}, expected {want}")
    moved = sum(not torch.equal(a, p) for a, p in zip(unet0, models[1].parameters()))
    same = all(torch.equal(a, p) for a, p in zip(
        frozen, [p for m in (models[0], models[2]) for p in m.parameters()]))
    log(f"train: {moved} of {len(unet0)} U-Net parameter tensors moved; text encoder "
        f"and autoencoder {'bit-unchanged' if same else 'CHANGED'}")
    check(moved == len(unet0) and same, "train: parameters moved where they should not, "
          "or stayed where they should move")
    _profile_report(prof, 2, f"train step at batch {batch}", prof_seconds * 1e3,
                    bare_ms=2 * s_per_step * 1e3)
    return launches, models


# Remat, resume and data-parallel phase: the remat policies of the LDM step
# and what each recomputes per step (the U-Net's 16 self-attention and 16
# FFN forwards once more; the autoencoder's attention is not in a segment)
REMAT_POLICIES = (False, True, "full", "blocks", "dots")
REMAT_EXTRA = {"flash_attention": 16, "fused_ffn": 16}
# Two ranks at batch 4 against one process at batch 8: bf16 rounding moves
# with the batch a kernel sees (the bf16 bound of the U-Net check, rel L2)
DP_TOL = 2e-2
# Step 4 of a resumed run (rel): the phase runs cuDNN deterministic, so it
# is expected bit-equal (printed); a kernel that sums in another order from
# run to run would move it by rounding only
RESUME_STEP4_TOL = 1e-3


def _group_rel(got: dict, want: dict, base: dict | None = None) -> dict:
    """rel L2 per ``_grad_group`` of ``got`` against ``want`` (of their
    differences from ``base`` when given), each tensor moved to the card."""
    import torch

    sums: dict[str, list] = {}
    on_card = lambda t: t.to("cuda", torch.float32)
    for name, w in want.items():
        g, w = on_card(got[name]), on_card(w)
        if base is not None:
            b = on_card(base[name])
            g, w = g - b, w - b
        acc = sums.setdefault(_grad_group(name), [0.0, 0.0])
        acc[0] += float((g - w).square().sum())
        acc[1] += float(w.square().sum())
    return {k: (d / max(n, 1e-30)) ** 0.5 for k, (d, n) in sums.items()}


def _ldm_steps(models, config, batch_images, batch_ids, policy, n: int, s0: dict,
               mesh=None):
    """``n`` LDM steps from the U-Net state ``s0`` with a fresh optimizer
    (EMA on): (losses, U-Net params after step 1, mu after step 1 (0.1 x
    the gradient), both copied to the host, seconds of steps 2..n, memory
    in GB: the most allocated before a step (``static``), the peak of a
    step's forward and backward (read as the optimizer starts) and of a
    whole step)."""
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.data.tokenizer import null_condition_ids
    from ldm_tf2_tpu_torch.training import ldm_trainer as lt

    cond, unet, ae = models
    unet.load_state_dict(s0)
    opt = lt.make_optimizer(**config["latent_diffusion_optimizer"])
    step = lt.make_ldm_train_step(
        unet, cond, ae, factory.build_schedule(config), opt,
        condition_dropout_rate=0.1, null_token_ids=null_condition_ids(1, 77)[0],
        remat_unet=policy, ema_decay=0.9999, seed=83, mesh=mesh)
    state = lt.init_ldm_train_state(unet, cond, opt, ema_decay=0.9999)
    losses, seconds = [], []
    first = mu = None
    memory = dict.fromkeys(("static", "fwd_bwd", "step"), 0.0)
    gb = lambda b: b / 1e9
    apply = opt.step_

    def step_(*args, **kw):  # the forward and backward's peak, as AdamW starts
        memory["fwd_bwd"] = max(memory["fwd_bwd"], gb(torch.cuda.max_memory_allocated()))
        return apply(*args, **kw)

    opt.step_ = step_
    for i in range(n):
        torch.cuda.synchronize()
        memory["static"] = max(memory["static"], gb(torch.cuda.memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch_images, batch_ids)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        memory["step"] = max(memory["step"], gb(torch.cuda.max_memory_allocated()))
        if i:
            seconds.append(time.perf_counter() - t0)
        else:
            first = {k: p.detach().cpu() for k, p in unet.named_parameters()}
            mu = {k[len("unet."):]: v.cpu() for k, v in state.opt_state["mu"].items()}
    return losses, first, mu, seconds, memory


def _write_jpeg_records(directory: str, n: int, seed: int) -> None:
    """``n`` Example records (a random JPEG 200-320 px a side, a caption of
    77 ids) in 4 TFRecord files, with the port's writers."""
    import io

    import numpy as np
    from PIL import Image

    from ldm_tf2_tpu_torch.data.example_proto import encode_example
    from ldm_tf2_tpu_torch.data.tfrecord import TFRecordWriter

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    writers = [TFRecordWriter(os.path.join(directory, f"part_{i}.tfrecord"))
               for i in range(4)]
    for i in range(n):
        h, w = (int(x) for x in rng.integers(200, 320, 2))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
        ids = [101] + [int(x) for x in rng.integers(1000, 30000, 19)] + [102]
        writers[i % 4].write(encode_example({"image": buf.getvalue(), "caption": ids}))
    for w in writers:
        w.close()


def phase_remat(card: str, models) -> None:
    """One LDM step at the north star (batch 8, 256^2, bf16 over float32
    masters, dropout 0.1, EMA on) from the same U-Net state and draws under
    each remat policy: the loss equal to the plain step's, the update and
    the gradient (Adam's first moment) within ``GRAD_TOL`` per group, the
    launches per step (the recomputed forwards included) on ``wgmma``; two
    more steps timed; each policy's peak memory, of a whole step and of its
    forward and backward (AdamW's temporaries over the gradients can set
    the first)."""
    import numpy as np
    import torch

    config = _train_config(8, 256)
    unet = models[1]
    s0 = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(81)
    images = torch.as_tensor(rng.uniform(-1, 1, (8, 256, 256, 3)),
                             dtype=torch.bfloat16, device="cuda")
    ids = torch.as_tensor(rng.integers(1000, 30000, (8, 77)), device="cuda")
    counters = _counters()
    plain = None
    report = []
    for policy in REMAT_POLICIES:
        torch.cuda.empty_cache()
        _reset(counters)
        losses, first, mu, seconds, memory = _ldm_steps(models, config, images, ids,
                                                        policy, 3, s0)
        launches = _read(counters)
        check_no_fma(f"remat {policy}")
        want = {k: 3 * (v + (REMAT_EXTRA.get(k, 0) if policy else 0))
                for k, v in TRAIN_STEP.items()}
        check(launches == want, f"remat {policy}: launches {launches}, expected {want}")
        s_step = statistics.mean(seconds)
        if plain is None:
            plain = (losses[0], first, mu)
            line = "the reference"
        else:
            upd = _group_rel(first, plain[1], s0)
            grad = _group_rel(mu, plain[2])
            ok = losses[0] == plain[0] and all(v < GRAD_TOL for v in (*upd.values(),
                                                                        *grad.values()))
            line = (f"loss {'bit-equal' if losses[0] == plain[0] else 'DIFFERS'} "
                    f"({losses[0]!r} vs {plain[0]!r}); update rel L2 per group "
                    + ", ".join(f"{g} {r:.2e}" for g, r in upd.items())
                    + "; gradient rel L2 per group "
                    + ", ".join(f"{g} {r:.2e}" for g, r in grad.items())
                    + f" (bound {GRAD_TOL:g}) {'PASS' if ok else 'FAIL'}")
            check(ok, f"remat {policy} differs from the plain step: {line}")
        report.append((policy, memory, s_step))
        log(f"remat {policy} on {card}: batch 8, 256^2, peak memory {memory['step']:.2f} GB "
            f"a step, {memory['fwd_bwd']:.2f} GB in its forward and backward, "
            f"{memory['static']:.2f} GB between steps; steps 2-3 {s_step:.4f} s/step "
            f"({', '.join(f'{x:.4f}' for x in seconds)}); launches over 3 steps "
            f"{launches}; {line}")
        del first, mu
    unet.load_state_dict(s0)
    log("remat summary (peak a step / forward and backward / between steps; s/step): "
        + "; ".join(f"{p}: {m['step']:.2f} / {m['fwd_bwd']:.2f} / {m['static']:.2f} GB, "
                    f"{s:.4f} s" for p, m, s in report))


def phase_resume(card: str, models) -> None:
    """``run_ldm_trainer.train`` on the indexed loader (``deterministic_data``)
    at the north star, cuDNN deterministic: 4 unbroken steps, then 2 steps
    saving a checkpoint and a fresh ``train()`` that resumes at step 2:
    steps 3-4's batches bit-equal, step 3's loss bit-equal, step 4's within
    ``RESUME_STEP4_TOL`` (printed: whether it is bit-equal too)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train
    from ldm_tf2_tpu_torch.data import indexed

    start = time.perf_counter()
    unet = models[1]
    s0 = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    tmp = tempfile.mkdtemp(prefix="ldm_resume_")
    seen: list = []
    original = indexed.create_indexed_dataset

    def teed(*args, **kw):  # what the trainer's loader yields, kept
        for b in original(*args, **kw):
            seen.append((b[0].copy(), b[1].copy()))
            yield b

    def run(ckpt, num_iterations):
        config = _train_config(8, 256, root_path=os.path.join(tmp, "records"),
                               ckpt_path=ckpt, num_iterations=num_iterations,
                               ema_decay=None)
        config["ldm_training"]["params"]["flip"] = True
        config["tpu"].update(deterministic_data=True, persist_per_iterations=2)
        config["latent_diffusion_optimizer"]["mu_dtype"] = "bfloat16"
        seen.clear()
        _, records = train(config, device="cuda", seed=85, models=models)
        return {r["step"]: r["loss"] for r in records}, list(seen)

    try:
        _write_jpeg_records(os.path.join(tmp, "records"), 40, 84)
        indexed.create_indexed_dataset = teed
        with _DeterministicCudnn():
            unet.load_state_dict(s0)
            unbroken, batches = run(None, 4)
            unet.load_state_dict(s0)
            first, _ = run(os.path.join(tmp, "ckpt"), 2)
            resumed, resumed_batches = run(os.path.join(tmp, "ckpt"), 4)
    finally:
        indexed.create_indexed_dataset = original
        shutil.rmtree(tmp, ignore_errors=True)
        unet.load_state_dict(s0)
    same_batches = len(resumed_batches) >= 2 and all(
        np.array_equal(a[k], b[k]) for a, b in zip(resumed_batches[:2], batches[2:4])
        for k in (0, 1))
    step4 = abs(resumed[4] - unbroken[4]) / abs(unbroken[4])
    ok = (sorted(unbroken) == [1, 2, 3, 4] and sorted(resumed) == [3, 4]
          and first == {1: unbroken[1], 2: unbroken[2]} and same_batches
          and resumed[3] == unbroken[3] and step4 < RESUME_STEP4_TOL
          and all(np.isfinite(list(unbroken.values()))))
    log(f"resume on {card}: indexed loader, 40 records, batch 8, 256^2, flips on; "
        f"unbroken losses {unbroken}; first run {first}; resumed at step 2: {resumed}; "
        f"steps 3-4 batches bit-equal {same_batches}, step 3 loss bit-equal "
        f"{resumed[3] == unbroken[3]}, step 4 rel {step4:.2e} (bound "
        f"{RESUME_STEP4_TOL:g}, bit-equal {resumed[4] == unbroken[4]}); "
        f"{time.perf_counter() - start:.1f} s {'PASS' if ok else 'FAIL'}")
    check(ok, "the resumed run differs from the unbroken one")


class _DeterministicCudnn:
    """cuDNN's deterministic algorithms inside the block (its weight
    gradients otherwise may sum in another order from run to run)."""

    def __enter__(self):
        import torch

        self.flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = self.flags


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_data_parallel(card: str, models) -> None:
    """The data-parallel code at world 1: an NCCL process group of this one
    process (``tcp://`` on localhost), in which the LDM steps (3), the AE GAN
    step (KL at the north star's width, batch 3, 256^2) and a CFG DDIM
    sampler call (eta 1, 10 steps) run through the all-reduces, the global
    batch statistics and the gather, each bit-equal to the plain run, with
    cuDNN deterministic for both; then two ranks on two cards against one
    process, when the machine has them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import rank_rows, sample_txt2img
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.parallel import create_mesh, gather_rows
    from ldm_tf2_tpu_torch.training import ae_trainer as at

    config = _train_config(8, 256)
    unet = models[1]
    s0 = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(91)
    images = torch.as_tensor(rng.uniform(-1, 1, (8, 256, 256, 3)),
                             dtype=torch.bfloat16, device="cuda")
    ids = torch.as_tensor(rng.integers(1000, 30000, (8, 77)), device="cuda")
    ae_config = _ae_config("kl")
    ae_models = _ae_models(ae_config, "cuda", 92)
    ae_s0 = [{k: v.detach().clone() for k, v in m.state_dict().items()}
             for m in ae_models[:2]]
    ae_images = torch.as_tensor(rng.uniform(-1, 1, (3, 256, 256, 3)),
                                dtype=torch.float32, device="cuda")
    sample_config = json.loads(json.dumps(NORTH_STAR))
    sample_config["ldm"].update(eta=1.0, num_ddim_steps=10)
    schedule = factory.build_schedule(validate(sample_config))
    tokens = torch.as_tensor(rng.integers(1000, 30000, (4, 77)))

    def ae_step(mesh):
        for m, s in zip(ae_models, ae_s0):
            m.load_state_dict(s)
        ae, disc, lpips = ae_models
        ae.requires_grad_(True).train()
        disc.requires_grad_(True).train()
        lpips.requires_grad_(False)
        trainer = ae_config["autoencoder_kl_trainer"]
        ae_opt, d_opt = at.make_adam(), at.make_adam()
        _, step2 = at.make_ae_train_steps(
            ae, disc, lpips, ae_opt, d_opt, lpips_weight=trainer["lpips_weight"],
            regularization_weight=trainer["kl_weight"],
            discriminator_weight=trainer["discriminator_weight"], seed=93, mesh=mesh)
        state = at.init_ae_train_state(ae, disc, ae_opt, d_opt)
        _, metrics = step2(state, ae_images)
        return ({k: float(v) for k, v in metrics.items()},
                [{k: v.detach().clone() for k, v in m.state_dict().items()}
                 for m in (ae, disc)])

    def sample(mesh):
        ids_, b = (tokens, 2) if mesh is None else rank_rows(tokens, 2, mesh)
        out, _ = sample_txt2img(*models, schedule, ids_, (b, 32, 32, 4), seed=94,
                                device="cuda", mesh=mesh)
        return gather_rows(out, mesh)

    start = time.perf_counter()
    try:
        with _DeterministicCudnn():
            plain = {"ldm": _ldm_steps(models, config, images, ids, False, 3, s0),
                     "ae": ae_step(None), "sample": sample(None)}
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
            try:
                mesh = create_mesh()
                got = {"ldm": _ldm_steps(models, config, images, ids, False, 3, s0, mesh),
                       "ae": ae_step(mesh), "sample": sample(mesh)}
            finally:
                dist.destroy_process_group()
    finally:
        unet.load_state_dict(s0)
    same_ldm = (got["ldm"][0] == plain["ldm"][0] and all(
        torch.equal(got["ldm"][1][k], v) for k, v in plain["ldm"][1].items()))
    same_ae = got["ae"][0] == plain["ae"][0] and all(
        torch.equal(g[k], v) for g, w in zip(got["ae"][1], plain["ae"][1])
        for k, v in w.items())
    same_sample = torch.equal(got["sample"], plain["sample"])
    ok = same_ldm and same_ae and same_sample and bool(torch.isfinite(got["sample"]).all())
    log(f"data parallel on {card}: world 1 (NCCL): LDM step losses {got['ldm'][0]} "
        f"bit-equal {same_ldm} (steps 2-3 {statistics.mean(got['ldm'][3]):.4f} s/step, "
        f"plain {statistics.mean(plain['ldm'][3]):.4f}; peak memory "
        f"{got['ldm'][4]['step']:.2f} GB, plain {plain['ldm'][4]['step']:.2f}); AE GAN "
        f"step {got['ae'][0]} bit-equal {same_ae}; "
        f"CFG DDIM sampler call (batch 2, 10 steps, eta 1) bit-equal {same_sample}; "
        f"{time.perf_counter() - start:.1f} s {'PASS' if ok else 'FAIL'}")
    check(ok, "the data-parallel code at world 1 differs from the plain run")
    del ae_models, ae_s0
    torch.cuda.empty_cache()
    if torch.cuda.device_count() < 2:
        log(f"data parallel, two ranks: skipped, this machine has "
            f"{torch.cuda.device_count()} card (two ranks need two)")
        return
    phase_two_ranks(card, s0)


def _two_ranks_main(rank: int, world: int, port: int, out: str) -> None:
    """One rank of ``phase_two_ranks``: the north-star models on
    ``cuda:<rank>``; rank 0 first takes the one-process step at batch 8,
    then both take the data-parallel step at batch 4 each."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ldm_tf2_tpu_torch.parallel import create_mesh, shard_batch

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        config = _train_config(8, 256)
        models = _train_models(config, f"cuda:{rank}")
        models[1].requires_grad_(True)
        s0 = {k: v.detach().cpu().clone() for k, v in models[1].state_dict().items()}
        rng = np.random.default_rng(95)
        images = torch.as_tensor(rng.uniform(-1, 1, (8, 256, 256, 3)),
                                 dtype=torch.bfloat16, device="cuda")
        ids = torch.as_tensor(rng.integers(1000, 30000, (8, 77)), device="cuda")
        if rank == 0:
            ref = _ldm_steps(models, config, images, ids, False, 2, s0)
        dist.barrier(device_ids=[rank])
        mesh = create_mesh()
        got = _ldm_steps(models, config, shard_batch(images, mesh),
                         shard_batch(ids, mesh), False, 2, s0, mesh)
        if rank == 0:
            result = {"world": mesh.world, "losses": got[0], "ref_losses": ref[0],
                      "update": _group_rel(got[1], ref[1], s0),
                      "grad": _group_rel(got[2], ref[2]),
                      "seconds": got[3], "ref_seconds": ref[3]}
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def phase_two_ranks(card: str, s0=None) -> None:
    """Two ranks on two cards (per-rank batch 4) against one process at
    batch 8: losses and per-group gradients (Adam's first moment after
    step 1) within ``DP_TOL``; the updates printed."""
    import tempfile

    import torch.multiprocessing as mp

    del s0
    out = os.path.join(tempfile.mkdtemp(prefix="ldm_dp_"), "result.json")
    start = time.perf_counter()
    mp.start_processes(_two_ranks_main, args=(2, _free_port(), out), nprocs=2,
                       join=True, start_method="spawn")
    with open(out) as f:
        r = json.load(f)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], r["ref_losses"]))
    ok = loss_rel < DP_TOL and all(v < DP_TOL for v in r["grad"].values())
    log(f"data parallel, two ranks on {card}: world {r['world']}, batch 4 per rank "
        f"against one process at batch 8: losses {r['losses']} vs {r['ref_losses']} "
        f"(rel {loss_rel:.2e}); gradient rel L2 per group "
        + ", ".join(f"{g} {v:.2e}" for g, v in r["grad"].items())
        + "; update rel L2 per group "
        + ", ".join(f"{g} {v:.2e}" for g, v in r["update"].items())
        + f" (bound {DP_TOL:g} on losses and gradients); 2nd step {r['seconds'][0]:.4f} s "
        f"per rank vs {r['ref_seconds'][0]:.4f} s for one process; "
        f"{time.perf_counter() - start:.1f} s {'PASS' if ok else 'FAIL'}")
    check(ok, f"two ranks differ from one process: {r}")


def _ae_config(ae_type: str, compute: str = "bfloat16", image_size: int = 256,
               batch: int = 3, num_iterations: int = 2, **ae_overrides) -> dict:
    """The repo config's stage-1 sections at full width (``AE_CONFIG`` and
    the north star's ``autoencoder_kl``), with GAN from step 1 for both
    types, seeded in-memory data and no checkpoints."""
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps({**NORTH_STAR, **AE_CONFIG}))
    config[f"autoencoder_{ae_type}"].update(ae_overrides)
    config[f"autoencoder_{ae_type}_trainer"]["global_step_discriminator"] = 1
    config["autoencoder_training"] = dict(
        root_path=None, params=dict(batch_size=batch, image_size=image_size,
                                    keys=["image"]),
        autoencoder_type=ae_type, ckpt_path=None, num_iterations=num_iterations)
    config["tpu"] = dict(compute_dtype=compute, log_per_iterations=1)
    return validate(config)


def _ae_models(config, device, seed: int):
    """Fresh (autoencoder, discriminator) float32 masters from ``seed`` and a
    seeded LPIPS (its real weights are not in the repository)."""
    from ldm_tf2_tpu_torch import factory

    training = config["autoencoder_training"]
    ae_type = training["autoencoder_type"]
    ae = factory.build_autoencoder(config, ae_type, device, None,
                                   resolution=training["params"]["image_size"])
    return (factory.init_params_(ae, seed),
            factory.init_params_(factory.build_discriminator(config, ae_type, device),
                                 seed + 1),
            factory.init_params_(factory.build_lpips(config, device), seed + 2))


def _ae_group(name: str) -> str:
    if name.startswith("d."):
        return "discriminator"
    if "attention" in name:
        return "attention"
    if "quantize" in name:
        return "codebook"
    if name.endswith("kernel") and "conv" in name:
        return "encoder convs" if name.startswith("encoder") else "decoder convs"
    return "norms, biases, dense"


def phase_ae_grad():
    """The AE trainer's phase-2 gradients (autoencoder, discriminator) and
    the discriminator's running statistics, card against CPU in float32
    (TF32 off), on a VQ autoencoder at full channel width at 64^2 with
    attention at 8^2, where the channels are 512: the flash forward and
    backward kernels run at S = 512, batch 2."""
    import torch

    from ldm_tf2_tpu_torch.training.ae_trainer import (
        init_ae_train_state, make_adam, make_ae_train_steps,
    )

    config = _ae_config("vq", "float32", image_size=64, batch=2,
                        attention_resolutions=[8])
    trainer = config["autoencoder_vq_trainer"]
    gen = torch.Generator().manual_seed(61)
    images = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    results, seconds = {}, {}
    counters = _counters()
    # the weights and running statistics as built, before the CPU's step
    # moves the statistics in place
    weights = [{k: v.clone() for k, v in m.state_dict().items()}
               for m in _ae_models(config, "cpu", 62)]
    for device in ("cpu", "cuda"):
        models = _ae_models(config, device, 62)
        for model, state in zip(models, weights):
            model.load_state_dict(state)
        ae, disc, lpips = models
        ae.requires_grad_(True)
        disc.requires_grad_(True)
        lpips.requires_grad_(False)
        opt = make_adam(**config["autoencoder_optimizer"])
        _, step2 = make_ae_train_steps(
            ae, disc, lpips, opt, opt, lpips_weight=trainer["lpips_weight"],
            regularization_weight=trainer["codebook_weight"],
            discriminator_weight=trainer["discriminator_weight"],
            discriminator_factor=trainer["discriminator_factor"], seed=63)
        state = init_ae_train_state(ae, disc, opt, opt)
        before = {k: fn.launches for k, fn in counters.items()}
        start = time.perf_counter()
        grads, d_grads, metrics = step2.grads(state, images.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            ran = {k: counters[k].launches - before[k] for k in
                   ("flash_attention", "flash_backward_dq", "flash_backward_dkv")}
        seconds[device] = time.perf_counter() - start
        named = {n: g for (n, _), g in zip(ae.named_parameters(), grads)}
        named.update({f"d.{n}": g for (n, _), g in zip(disc.named_parameters(), d_grads)})
        stats = {f"d.{n}": b for n, b in disc.named_buffers()}
        with torch.no_grad():
            _, _, idx = ae.encode(images.to(device))
        results[device] = ({n: g.float().cpu() for n, g in named.items()},
                           {n: b.float().cpu() for n, b in stats.items()},
                           {k: float(v) for k, v in metrics.items()}, idx.cpu())
    del models
    torch.cuda.empty_cache()
    (g_cpu, s_cpu, m_cpu, i_cpu), (g_gpu, s_gpu, m_gpu, i_gpu) = results["cpu"], results["cuda"]
    groups: dict[str, list] = {}
    for n, want in g_cpu.items():
        groups.setdefault(_ae_group(n), []).append((g_gpu[n].flatten(), want.flatten()))
    report = {}
    for group, pairs in groups.items():
        got = torch.cat([a for a, _ in pairs])
        want = torch.cat([b for _, b in pairs])
        report[group] = (float((got - want).norm() / want.norm()), len(pairs))
    stats_rel = max(float((s_gpu[n] - w).norm() / w.norm().clamp_min(1e-30))
                    for n, w in s_cpu.items())
    # relative to the value, or to 1e-3 where a loss (g_loss) lies near 0
    metric_rel = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-3) for k, v in m_cpu.items()}
    same_codes = bool(torch.equal(i_cpu, i_gpu))
    ok = (all(rel < AE_GRAD_TOL for rel, _ in report.values()) and stats_rel < AE_GRAD_TOL
          and all(r < AE_GRAD_TOL for r in metric_rel.values()) and same_codes
          and all(v > 0 for v in ran.values()))
    log(f"AE grad: VQ autoencoder at full width (64^2, attention at 8^2, S = 512), "
        f"batch 2, phase-2 loss, card vs CPU float32 (card {seconds['cuda']:.2f} s, CPU "
        f"{seconds['cpu']:.1f} s): " + "; ".join(
            f"{g} rel_l2 {r:.2e} ({n} tensors)" for g, (r, n) in report.items())
        + f"; running stats rel_l2 {stats_rel:.2e}; metrics rel "
        + ", ".join(f"{k} {v:.1e}" for k, v in metric_rel.items())
        + f"; codes equal {same_codes}; card launches {ran} (bound {AE_GRAD_TOL:g}) "
        + ("PASS" if ok else "FAIL"))
    check(ok, f"AE gradients on the card disagree with the CPU's: {report}, stats "
          f"{stats_rel:.2e}, metrics {metric_rel}, codes equal {same_codes}, {ran}")


def phase_ae_train(card: str):
    """The stage-1 trainer through ``run_autoencoder_trainer.train``: the VQ
    autoencoder at the repo config's full width, batch 3, 256^2, bf16
    compute over float32 masters, GAN from step 1, in-memory batches: 2
    warm-up steps, 5 timed steps with the launch counts read around them,
    1 profiled GAN step; then 3 steps of the KL autoencoder with its
    discriminator, through both phases.  Each ``train`` call starts from a
    fresh optimizer state at step 0 (phase 1) and goes on training the same
    models."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldm_tf2_tpu_torch.cli.run_autoencoder_trainer import train

    batch, size = 3, 256
    rng = np.random.default_rng(71)
    counters = _counters()
    flash = ("flash_attention", "flash_backward_dq", "flash_backward_dkv")
    out = {}
    for ae_type, seed in (("vq", 72), ("kl", 75)):
        config = _ae_config(ae_type)
        start = time.perf_counter()
        models = _ae_models(config, "cuda", seed)
        torch.cuda.synchronize()
        n_params = [sum(p.numel() for p in m.parameters()) / 1e6 for m in models]
        log(f"AE train {ae_type}: built autoencoder {n_params[0]:.1f} M, discriminator "
            f"{n_params[1]:.1f} M, LPIPS {n_params[2]:.1f} M params in "
            f"{time.perf_counter() - start:.1f} s")

        def run(steps, gan_from=1):
            config["autoencoder_training"]["num_iterations"] = steps
            config[f"autoencoder_{ae_type}_trainer"]["global_step_discriminator"] = gan_from
            data = [rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
                    for _ in range(steps)]
            torch.cuda.synchronize()
            _reset(counters)
            t0 = time.perf_counter()
            _, records = train(config, device="cuda", seed=seed, batches=data,
                               models=models)
            torch.cuda.synchronize()
            launches = _read(counters)
            return records, time.perf_counter() - t0, launches

        if ae_type == "kl":  # a few steps through both phases
            records, seconds, launches = run(3)
            steps = 3
        else:
            warm, _, _ = run(2)
            torch.cuda.reset_peak_memory_stats()
            steps = 5
            records, seconds, launches = run(steps)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_no_fma(f"AE train {ae_type}, {steps} steps")
        per_step = {k: launches[k] / steps for k in flash}
        want = AE_STEP_ATTENTIONS[ae_type]
        others = {k: v for k, v in launches.items() if k not in flash and v}
        finite = all(np.isfinite(v) for r in records for k, v in r.items()
                     if k not in ("step", "time"))
        gan = [r for r in records if "adaptive_weight" in r]
        ok = (finite and all(v == want for v in per_step.values()) and not others
              and len(gan) == steps - 1)
        step_s = [b["time"] - a["time"] for a, b in zip(records[1:], records[2:])]
        s_per_step = statistics.median(step_s)
        losses = "; ".join(
            f"step {r['step']} ae {r['ae_loss']:.4f} nll {r['nll_loss']:.4f} reg "
            f"{r['reg_loss']:.4g}" + (f" g {r['g_loss']:.4f} d {r['d_loss']:.4f} weight "
                                      f"{r['adaptive_weight']:.4g}"
                                      if "adaptive_weight" in r else "")
            for r in records)
        memory = f"peak memory {peak_gb:.2f} GB; " if ae_type == "vq" else ""
        log(f"AE train {ae_type} on {card}: batch {batch}, {size}^2, bf16 compute, "
            f"{steps} steps in {seconds:.3f} s (optimizer state and phase-1 step "
            f"included); steps 3-{steps}: {s_per_step:.4f} s/step median "
            f"({', '.join(f'{x:.4f}' for x in step_s)}), {batch / s_per_step:.3f} img/s; "
            f"{memory}flash launches per step {per_step} (want {want} each), other "
            f"kernels {others}; {losses}; finite {finite} {'PASS' if ok else 'FAIL'}")
        check(ok, f"AE train {ae_type}: launches per step {per_step} (want {want}), "
              f"others {others}, finite {finite}, GAN steps {len(gan)}")
        out[ae_type] = dict(s_per_step=s_per_step, launches=per_step)
        if ae_type == "vq":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_records, prof_seconds, _ = run(1, gan_from=0)
            check("adaptive_weight" in prof_records[0], "the profiled step was not a GAN step")
            _profile_report(prof, 1, f"VQ AE GAN train step at batch {batch}",
                            prof_seconds * 1e3, bare_ms=s_per_step * 1e3)
        del models
        torch.cuda.empty_cache()
    return out


def _profile_report(prof, n: int, what: str, wall_ms: float,
                    bare_ms: float | None = None) -> None:
    """Device time by kernel group per unit over a profiled window of ``n``
    units, and the device's idle share of the window's wall time (and of
    ``bare_ms``, the same work timed without the profiler, when given).
    Returns the device busy time and the launches per unit (None when the
    window recorded no device time)."""
    import torch

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
        return None
    parts = ", ".join(f"{k} {v / n:.2f} ms ({v / busy:.1%})"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    launches = sum(c for _, c in kernels.values()) / n
    bare = "" if bare_ms is None else (
        f"{bare_ms / n:.2f} ms wall per unit without the profiler, ")
    idle = "" if bare_ms is None else f"{1 - busy / bare_ms:.1%} of the unprofiled wall, "
    log(f"profile: {what}, {n} units: {bare}{wall_ms / n:.2f} ms with it; device busy "
        f"{busy / n:.2f} ms in {launches:.0f} kernel launches, idle share {idle}"
        f"{1 - busy / wall_ms:.1%} profiled; by group: {parts}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("profile: top kernels per unit: " + "; ".join(
        f"{name[:60]} {ms / n:.3f} ms x{c // n}" for name, (ms, c) in top))
    return {"busy_ms": busy / n, "launches": launches}


def phase_profile(unet, shape, evals: int = 3, what: str | None = None,
                  cache_levels: int | None = None):
    """Device time by kernel group over a few U-Net evals at the CFG batch
    of a latent ``shape`` (shallow passes of ``cache_levels`` levels, fed a
    fresh cache, when given), and the device's idle share of the window;
    returns ``_profile_report``'s busy time and launches per eval."""
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
        kw = {}
        if cache_levels:
            cache = unet(x, t, ctx, return_cache=True, cache_levels=cache_levels)[1]
            kw = dict(shallow_cache=cache, cache_levels=cache_levels)
        unet(x, t, ctx, **kw)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(evals):
            unet(x, t, ctx, **kw)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(evals):
                unet(x, t, ctx, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    modes = what or ("int8 + int8-P.V" if unet.conv_quant else "bf16")
    if cache_levels:
        modes += f" shallow (cache_levels {cache_levels})"
    return _profile_report(prof, evals, f"{modes} U-Net eval at CFG batch {b2}", wall_ms,
                           bare_ms)


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
    seconds = _build.build(SOURCES)
    log("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    results = phase_kernels()
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn_int8

    ffn8_checked = fused_ffn_int8.launches  # the kernels phase's own launches
    ffn8_paths = dict(fused_ffn_int8.launches_by_path)
    phase_unet()
    phase_grad()
    launches, run = phase_main_path(card)
    by_path = {k: dict(LAST_PATHS[k]) for k in ("flash_attention", "fused_ffn")}
    # the opt-in kernels report their launches in the opt-in main path (the
    # stats kernel in its GroupNorm "stats" run), the serving path's in the
    # serve run, the backward kernels theirs in the LDM train run (5 steps)
    opt_in, stats, opt_paths = phase_opt_in(card, run)
    by_path.update(opt_paths)
    launches.update({k: opt_in[k] for k in ("group_norm_fused", "gn_silu_conv3x3_fused",
                                            "cross_attention")})
    launches["group_stats"] = stats["group_stats"]
    phase_samplers(card, run)
    phase_deepcache_img2img(card, run)
    convert_launches = phase_convert_export_eval(card)
    serve = phase_serve(card, run["models"])
    by_path.update({k: dict(LAST_PATHS[k]) for k in ("flash_attention_pv_int8", "s8_conv3x3")})
    by_path["gn_silu_quant"] = dict(LAST_MODES["gn_silu_quant"])
    launches.update({k: serve[k] for k in ("gn_silu_quant", "s8_conv3x3",
                                           "flash_attention_pv_int8")})
    del run
    torch.cuda.empty_cache()
    train_launches, train_models = phase_train(card)
    by_path.update({k: dict(LAST_PATHS[k]) for k in ("flash_backward_dq", "flash_backward_dkv")})
    phase_remat(card, train_models)
    phase_resume(card, train_models)
    phase_data_parallel(card, train_models)
    del train_models
    torch.cuda.empty_cache()
    launches.update({k: train_launches[k] for k in ("flash_backward_dq",
                                                    "flash_backward_dkv")})
    phase_ae_grad()
    phase_ae_train(card)
    # row 4 is dispatched on no path, as in the JAX package: its count is
    # the sum over every path run; rows 9 and 10 count the serve run's
    # launches of rows 8 and 11 at the shapes where the TPU ran them
    launches.update(fused_ffn_int8=PATH_TOTALS["fused_ffn_int8"],
                    gn_silu_quant_stream=serve["gn_silu_quant_stream"],
                    int8_chain=serve["int8_chain"])

    replaces = {"flash_attention": "ldm_tf2_tpu/ops/flash_attention.py:147",
                "fused_ffn": "ldm_tf2_tpu/ops/fused_ffn.py:132",
                "gn_silu_quant": "ldm_tf2_tpu/ops/quant_conv.py:104",
                "s8_conv3x3": "ldm_tf2_tpu/ops/quant_conv.py:722",
                "flash_attention_pv_int8": "ldm_tf2_tpu/ops/flash_attention.py:186",
                "flash_backward_dq": "ldm_tf2_tpu/ops/flash_attention.py:347",
                "flash_backward_dkv": "ldm_tf2_tpu/ops/flash_attention.py:392",
                "group_norm_fused": "ldm_tf2_tpu/ops/group_norm.py:115",
                "group_stats": "ldm_tf2_tpu/ops/group_norm.py:192",
                "gn_silu_conv3x3_fused": "ldm_tf2_tpu/ops/fused_conv.py:178",
                "cross_attention": "ldm_tf2_tpu/ops/cross_attention.py:84",
                "fused_ffn_int8": "ldm_tf2_tpu/ops/fused_ffn.py:176",
                "gn_silu_quant_stream": "ldm_tf2_tpu/ops/quant_conv.py:209",
                "int8_chain": "ldm_tf2_tpu/ops/quant_conv.py:411"}
    source = {"flash_backward_dq": "flash_attention_bwd",
              "flash_backward_dkv": "flash_attention_bwd",
              "group_norm_fused": "group_norm", "group_stats": "group_norm",
              "gn_silu_conv3x3_fused": "gn_silu_conv3x3",
              "gn_silu_quant_stream": "gn_silu_quant",
              "int8_chain": "s8_conv3x3"}
    kernels = []
    for name, rows in results.items():
        main_row = rows[0]  # bf16 at the path's first (level-0) shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ldm_tf2_tpu_torch/csrc/{source.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "library_device_ms": main_row["library_device_ms"],
        })
        if name in by_path:  # the launches above by path (wgmma, mma.sync, fma)
            kernels[-1]["launches_by_path"] = by_path[name]
        if convert_launches[name]:  # the sampler CLI on the converted blob
            kernels[-1]["converted_blob_launches"] = convert_launches[name]
        per_eval = {k: v for k, v in EVAL_SUMS.items() if k.split()[0] == name}
        if per_eval:  # over one U-Net eval's calls (rows 2, 5, 7, 8, 11)
            kernels[-1]["per_eval"] = per_eval
        if name == "fused_ffn_int8":  # on no path; row 2 as the yardstick
            kernels[-1].update(kernels_phase_launches=ffn8_checked,
                               kernels_phase_launches_by_path=ffn8_paths,
                               bf16_ffn_ms=main_row["bf16_ffn_ms"],
                               bf16_ffn_device_ms=main_row["bf16_ffn_device_ms"],
                               clusters={f"{r['shape'][0]}x{r['shape'][1]}": r["cluster"]
                                         for r in rows})
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
