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
   (``device_ms``, and the library call's ``library_device_ms``); row 2's
   partial-product mode (tensor parallelism) at every shard shape
   (``FFN_TP_SHAPES``: F / 2 and F / 4 at the four main-path widths), bf16
   on wgmma and float32 on the FMA path, two calls bit-equal;
3b. tp layers: a level-0 and a level-3 SpatialTransformer, a ResidualBlock
   and a text-encoder layer at full width, sharded by ``shard_params_tp`` at
   model 2 and 4, each rank a thread on the one card, the partials summed
   in rank order, against the whole layer (``TP_LAYER_TOL`` in float32,
   ``TP_BF16_FACTOR`` in bf16); at model 2 also with the opt-in switches on;
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
   call in the int8 serving modes at batch 4; each call's launches held
   to ``eval_counts``;
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
   launch on wgmma, every GN+SiLU+quantize launch resident; its warm-up
   captures the whole call as one graph, and the two calls replay it;
6a. graphs (``phase_graphs``): the sampling path's U-Net evals captured as
   CUDA graphs and replayed (``diffusion/graphs.py``; every sampling phase
   above already runs so, the entry points' default), each run beside its
   eager run (``graphs=False``) on the same seed and weights: the main
   path in turns (eager, graphed, graphed, eager), the same call at
   bench.py's headline batch 24, img2img and the opt-in route; x0 and
   images bit-equal, launches per call equal, s per call, peak memory and
   each capture's seconds;
   one eval of each route (default at CFG 4 and 48, the DeepCache shallow
   pass, opt-in, int8) profiled eager and graphed: kernel launches per
   eval from the trace equal, wall and busy ms per eval, idle share;
6c. serve program (``phase_serve_program``, after 6a): the server's call
   (text encode, loop, decode) as one CUDA graph at batch 4 in seven
   configurations (``SERVE_PROGRAM_CONFIGS``: int8 + int8-P.V and bf16
   DDIM, eta 1, DeepCache, DPM-Solver++(2M), PLMS, DDPM; DDPM's call as
   its encode, a graph of ``DDPM_RUN_STEPS`` steps replayed in turn and its
   decode, ``diffusion/graphs.py``), through the
   server's own ``run_batch``: the eager server's call (``graphs=False``),
   the per-eval graphed call and the program's warm-up and three replays
   (``SERVE_PROGRAM_CALLS``) with images bit-equal, counts equal, s per
   call each way, capture seconds, kernel nodes, graph pool, the host's
   ms of the program's weights check, a profiled replay where the
   configuration says so, and a replaced U-Net tensor recapturing; first
   the eager encode and decode (``phase_encode_decode``).  With arguments
   the script runs named phases of this run alone (``ALONE``: ``serve``,
   ``serve_program``, ``encode_decode``, ``loader``); each phase logs its
   seconds;
6b. tp / sp (``phase_tp_sp``): two spawned gloo ranks on the one card
   (NCCL ranks too where the machine has two or four cards), each calling
   ``dist.init_process_group`` before the port: the collectives on CUDA
   tensors, a full-width TP sampler call (``TP_SP_STEPS`` CFG DDIM steps,
   batch 2, 256^2, ``{"data": 1, "model": 2}``; row 2's partial-mode
   launches read around it), an SP call at 512^2 (latent [2, 64, 64, 4],
   Ulysses calls counted), a ``serve()`` wave on ``{"data": 2}``, each
   against the one-process call on the same weights (``TP_SP_TOL``), with
   all-reduces per U-Net eval and text encode, weight bytes, peak memory
   and eval times per rank;
7. train: the stage-2 trainer (``cli/run_ldm_trainer.train``) at the
   north-star widths, batch 8, 256^2, bf16 compute over float32 U-Net
   masters, frozen text encoder and autoencoder in bf16, U-Net and
   condition dropout 0.1, EMA on, in-memory batches: 2 warm-up steps, then
   5 timed steps with the launch counts read around them (``TRAIN_STEP``),
   then 2 steps under the profiler, every ``train`` call graphed (its first
   step eager, then replays); then (7a) the train steps' CUDA graphs
   (``phase_train_graphs``, ``training/graphs.py``): 4 eager and 4 graphed
   steps from one start, cuDNN deterministic, for the LDM step (EMA, clip
   1.0), with ``grad_accum_steps: 2`` and with remat "blocks", the VQ
   autoencoder's GAN step and the KL autoencoder's phase-1 step (batch 3):
   losses, parameters, moments, EMA and D's statistics bit-equal, launch
   counts equal, the replayed graph's kernel nodes by name equal to the
   eager step's captured into a graph, s/step, busy ms and idle share
   each, peak memory, the graph pool and capture seconds; then (7b) one
   step under each remat
   policy (``tpu.remat`` false, true, full, blocks, dots) from the same
   state, graphed, the loss equal to the plain step's, the update and the gradient
   within ``GRAD_TOL`` per group, each policy's peak memory and s/step
   (``phase_remat``); the indexed loader's resume through ``train`` with
   ``deterministic_data`` (``phase_resume``: 4 steps unbroken against 2 +
   2 resumed from a checkpoint, the batches bit-equal); the native reader
   (``phase_loader``, ``data/native``, built from the checkout's source
   and required): 256 seeded 256^2 JPEG records, its framing index,
   ``pread`` bytes and captions against the Python path's, one epoch of
   the indexed and the streaming loader native against Python (equal, or
   within one code with the differing values counted), img/s each way,
   and 2 graphed LDM steps at batch 8 fed by the native indexed loader; and the
   data-parallel code at world 1 in an NCCL group of one process, the LDM
   step, the AE GAN step and a CFG sampler call each bit-equal to the
   plain run, then two ranks against one process when the machine has two
   cards (``phase_data_parallel``); then (7c) the LDM step under tensor
   parallelism at full width (``phase_tp_train``): two gloo ranks on the
   one card on ``{"model": 2}`` (NCCL x2 and, with four cards, x4 on
   ``{"data": 2, "model": 2}`` too) against one process at batch 2 (rank
   0's), in float32 (TF32 off) and bf16: step 1's gradients per group,
   the clip's global norm, replicated leaves bit-equal on the peers, the
   launches of a step (``TP_TRAIN_STEP``), s/step and peak memory per
   rank, and a checkpoint saved under TP (whole leaves) and restored bit
   for bit.  Before it, the kernels phase checks the flash forward and
   backward kernels at the training path's shapes (the TP step's local
   heads among them), and a gradient
   phase holds a north-star-width U-Net's parameter gradients on the card
   to the CPU's in float32, with the opt-in switches off and on;
8. AE train: the stage-1 trainer (``cli/run_autoencoder_trainer.train``)
   on the repo config's VQ autoencoder at full width (channels 128,
   multipliers [1, 2, 2, 4], attention at 32^2, codebook 16384 x 4), its
   PatchGAN and a seeded LPIPS VGG16, batch 3, 256^2, bf16 compute, GAN
   from step 1: 2 warm-up steps, 5 timed with the flash launch counts read
   around them (``AE_STEP_ATTENTIONS``), 1 profiled GAN step; then 3 steps
   of the KL autoencoder with its discriminator, through both phases, all
   graphed.
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

import contextlib
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
# carried by the kernels of rows 8 and 11 and measured at their own shapes;
# row 2's partial-product mode (tensor parallelism: the TPU kernel with
# residual=False) has an entry of its own.
KERNELS = ("flash_attention", "fused_ffn", "gn_silu_quant", "s8_conv3x3",
           "flash_attention_pv_int8", "flash_backward_dq", "flash_backward_dkv",
           "group_norm_fused", "group_stats", "gn_silu_conv3x3_fused",
           "cross_attention", "fused_ffn_int8", "gn_silu_quant_stream",
           "int8_chain", "fused_ffn_partial")

# (B, Tq, Tk, H, S): the main path's self-attentions (CFG batch 4), then
# the serve path's bf16 ones (CFG batch 8; its level-0 ones take int8 P.V)
ATTN_SHAPES = [
    (4, 1024, 1024, 8, 40), (4, 256, 256, 8, 80), (4, 64, 64, 8, 160),
    (4, 16, 16, 8, 160), (2, 1024, 1024, 1, 512), (4, 1000, 1000, 8, 40),
    (8, 256, 256, 8, 80), (8, 64, 64, 8, 160), (8, 16, 16, 8, 160),
    (3, 1024, 1024, 1, 512), (8, 1024, 1024, 1, 512), (2, 1024, 1000, 1, 512),
] + [(2, t, t, 8 // n, s) for t, s in ((1024, 40), (256, 80), (64, 160)) for n in (2, 4)]
# the autoencoder's S = 512 above: the sampling decode (batch 2), the VQ AE
# train step (batch 3), the LDM train step's encode (batch 8), a ragged kv;
# last, the tensor-parallel train step's local heads (phase_tp_train's batch
# 2, levels 0-2, 8 / n heads at model n = 2 and 4).
# Every bf16 launch at the models' head dims takes the wgmma path (read
# from the wrappers' launches_by_path); float32 the FMA path.
WGMMA_HEAD_DIMS = (40, 80, 160, 512)
# (M, d): the main path's FFNs (CFG batch 4), then the serve path's (batch 8)
FFN_SHAPES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280),
              (8192, 320), (2048, 640), (512, 1280), (128, 1280)]
# (M, d, n): the FFN's tensor-parallel shards, every level-0..3 shape of the
# main path (CFG batch 4, 256^2) at F / n hidden columns, n = 2 and 4
FFN_TP_SHAPES = [(m, d, n) for m, d in FFN_SHAPES[:4] for n in (2, 4)]
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
# key would overflow exp()), then the autoencoder's 512-wide head, then the
# tensor-parallel step's local heads (the last six of ATTN_SHAPES)
BWD_SHAPES = [
    (8, 1024, 1024, 8, 40, False), (8, 256, 256, 8, 80, False),
    (8, 64, 64, 8, 160, False), (8, 16, 16, 8, 160, False),
    (4, 1000, 1000, 8, 40, True), (2, 1024, 1024, 1, 512, False),
    (3, 1024, 1024, 1, 512, False), (8, 1024, 1024, 1, 512, False),
] + [shape + (False,) for shape in ATTN_SHAPES[-6:]]
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
              "int8_chain": 0, "fused_ffn_partial": 0}

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
    phase_ffn_partial_kernel(results, randn)
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
    # launch a call (``_launches_per_call``), resident in the clusters' shared
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
            one = _launches_per_call(lambda: qc.gn_silu_quant(x, gamma, beta))
            ok = (sa_rel <= 1e-6 and codes_max <= 1 and flipped <= 1e-3 and same
                  and mode == {**dict.fromkeys(mode, 0), want: 2} and one == 1)
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
                f"two calls equal {same}, path {mode} (want {want}), {one} launches a "
                f"call (want 1; the trace recorded {per_call[0]:g}) "
                f"{'PASS' if ok else 'FAIL'}; ms {ms:.4f} plain "
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
            if timed:  # one kernel a call
                ok = ok and _launches_per_call(lambda: ff.fused_ffn_int8(*args)) == 1
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


def phase_ffn_partial_kernel(results, randn):
    """Row 2's partial-product mode at every tensor-parallel shard shape
    (``FFN_TP_SHAPES``): the product over F / n hidden columns rounded to
    the activation dtype, against the plain version's in float32
    (``FFN_TOL``), bf16 on wgmma, float32 on the FMA path, two calls
    bit-equal; bf16 timed, with the unfused chain of PyTorch calls for the
    same product as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from ldm_tf2_tpu_torch.ops.fused_ffn import _plain_ffn, fused_ffn

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        path = "wgmma" if dtype == torch.bfloat16 else "fma"
        for m, d, n in FFN_TP_SHAPES:
            f = 4 * d // n
            x = randn(1, m, d).to(dtype)
            lns, lnb = randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)
            ws = [randn(d, f, scale=d**-0.5), randn(f, scale=0.1), randn(d, f, scale=d**-0.5),
                  randn(f, scale=0.1), randn(f, d, scale=(4 * d)**-0.5), randn(d, scale=0.1)]
            ws = [w.to(dtype) for w in ws]
            before = dict(fused_ffn.partial_launches_by_path)
            out = [fused_ffn(x, lns, lnb, *ws, partial=True) for _ in range(2)]
            took = {k: v - before[k] for k, v in fused_ffn.partial_launches_by_path.items()
                    if v - before[k]}
            ref = _plain_ffn(x.float(), lns, lnb, *[w.float() for w in ws], partial=True)
            torch.cuda.synchronize()
            max_abs, rel = errors(out[0], ref)
            same = bool(torch.equal(out[0], out[1]))
            tol_abs, tol_rel = FFN_TOL[name]
            ok = max_abs < tol_abs and rel < tol_rel and same and took == {path: 2}
            row = dict(shape=[m, d, n], dtype=name, max_abs_err=max_abs, rel_l2=rel, ok=ok,
                       paths=took, deterministic=same)
            timing = ""
            if dtype == torch.bfloat16:
                w1 = torch.cat([ws[0], ws[2]], dim=1).T.contiguous()
                b1 = torch.cat([ws[1], ws[3]])
                w2t = ws[4].T.contiguous()
                lnd = (lns.to(dtype), lnb.to(dtype))

                def library():
                    h = F.linear(F.layer_norm(x, (d,), *lnd), w1, b1)
                    return F.linear(h[..., :f] * F.gelu(h[..., f:]), w2t)

                call = lambda: fused_ffn(x, lns, lnb, *ws, partial=True)
                nbytes = (2 * x.numel() + sum(w.numel() for w in ws[:5])) * x.element_size() \
                    + 2 * d * 4
                bms, by = bound_ms(nbytes, 6.0 * m * d * f, name)
                row.update(ms=time_ms(call), device_ms=device_ms(call),
                           plain_ms=time_ms(lambda: _plain_ffn(x, lns, lnb, *ws, partial=True)),
                           library_ms=time_ms(library), library_device_ms=device_ms(library),
                           bound_ms=bms, bound_by=by)
                timing = (f"; ms {row['ms']:.4f} device {row['device_ms']:.4f} plain "
                          f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} (device "
                          f"{row['library_device_ms']:.4f}) bound {bms:.4f} ({by})")
            results["fused_ffn_partial"].append(row)
            log(f"fused_ffn partial {name} M {m} d {d} F/{n} = {f}: max_abs {max_abs:.3e} "
                f"(tol {tol_abs:g}) rel_l2 {rel:.3e} (tol {tol_rel:g}) two calls equal "
                f"{same} path {took} (want {path}) {'PASS' if ok else 'FAIL'}{timing}")


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
            ok = ok and _launches_per_call(fns["kernel"]) == 1
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
    models = _north_star_models(config)
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


def _north_star_models(config) -> list:
    """The north star's text encoder, U-Net and KL autoencoder on the card,
    their weights drawn from seeds 21, 22 and 23 (``factory.randomize_``)."""
    from ldm_tf2_tpu_torch import factory

    return [factory.randomize_(build(config, device="cuda"), seed)
            for seed, build in ((21, factory.build_cond_model),
                                (22, factory.build_unet),
                                (23, factory.build_autoencoder))]


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
    too (the partial FFN's by path among them)."""
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    for fn in counters.values():
        fn.launches = 0
    for fn in (*_path_wrappers().values(), *_mode_wrappers().values()):
        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    fused_ffn.partial_launches_by_path = dict.fromkeys(fused_ffn.partial_launches_by_path, 0)


def _read(counters) -> dict:
    """The counts of one path run, its counters set to 0 just before it
    (``_reset``); also added to ``PATH_TOTALS``.  The launches by path go
    to ``LAST_PATHS``, by mode to ``LAST_MODES``."""
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    got = {k: fn.launches for k, fn in counters.items()}
    for k, v in got.items():
        PATH_TOTALS[k] = PATH_TOTALS.get(k, 0) + v
    LAST_PATHS.clear()
    LAST_PATHS.update({k: dict(fn.launches_by_path) for k, fn in _path_wrappers().items()})
    LAST_PATHS["fused_ffn_partial"] = dict(fused_ffn.partial_launches_by_path)
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
            "cross_attention": ca.cross_attention,
            "fused_ffn_partial": _Count(fused_ffn, "partial_launches")}


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
    mask that keeps the left half; one DDIM DeepCache call in the int8
    serving modes at batch 4 (the server's DeepCache calls:
    ``phase_serve_program``).  Each call's launches are counted around it and held to what
    its evals dispatch (``eval_counts``); DeepCache and plain DDIM are then
    timed in turns."""
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import (
        load_init_image, load_mask, sample_img2img, sample_txt2img,
    )
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

    # DDIM DeepCache in the int8 serving modes at batch 4 (CFG 8); the
    # server with DeepCache is phase_serve_program's
    int8_config = {"tpu": dict(quantize="int8", quantize_attention="int8pv")}
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


SERVE_REQUESTS = "\n".join([
    json.dumps({"prompt": "a virus monster is playing guitar", "n": 2,
                "seed": 1, "guidance_scale": 5.0, "out": "s1"}),
    json.dumps({"prompt": ["an oil painting of a harbour", "a red fox"],
                "seed": 1, "guidance_scale": 7.5, "out": "s2"}),
    json.dumps({"prompt": "a lighthouse at dusk", "n": 1, "seed": 2,
                "out": "s3"}),
    "this is not json",
])


def _serve_config() -> dict:
    """The serve phase's config: the north star at batch 4 in both int8
    serving modes."""
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(NORTH_STAR))
    config["ldm_sampling"].update(
        latent_shape=[4, 32, 32, 4], vocab_dir=os.path.join(ROOT, "bert_model"))
    config["tpu"].update(quantize="int8", quantize_attention="int8pv")
    return validate(config)


def phase_serve(card: str, models):
    """The JSONL server in the int8 serving modes at the north-star widths,
    driven through ``serve()`` with an in-memory stream: two requests of
    seed 1 that pack into one batch-4 call, one of seed 2 (a padded call),
    one malformed line.  Counts are read around the whole run: the warm-up
    call and the two request calls.  The warm-up captures the whole call
    as one graph (``diffusion/graphs.py::SamplingProgram``) and the two
    request calls replay it: one capture, two replays, and stderr's report
    of the capture, its seconds and its kernel nodes."""
    import io
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.diffusion import graphs

    config = _serve_config()
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

    counters = _counters()
    out, err = io.StringIO(), io.StringIO()
    store = graphs.STORE
    made, replays = len(store.capture_seconds), store.replays
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        start = time.perf_counter()
        with contextlib.redirect_stderr(err):
            serve_ldm.serve(config, io.StringIO(SERVE_REQUESTS), out, output_dir=out_dir,
                            device="cuda", models=models)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = _read(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        made, replays = len(store.capture_seconds) - made, store.replays - replays
        for line in err.getvalue().splitlines():
            log(f"serve stderr: {line}")
        check(made == 1 and replays == 2 and "captured 1 call graph(s)" in err.getvalue(),
              f"serve: {made} capture(s) and {replays} replay(s), expected the warm-up's "
              "one capture of the whole call and a replay for each of the 2 calls")
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
        f"memory {peak_gb:.2f} GB; {made} capture of the whole call, {replays} replays; "
        f"launches over {calls} calls {launches}")
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


# Bench.py's headline batch (bench.py:226-231): 24 latents, CFG batch 48
GRAPHS_HEADLINE_BATCH = 24
# Evals timed bare (no profiler) and profiled in one window for each eval pair
GRAPHS_EVALS = (3, 5)


def _graph_pool_gb() -> float:
    """Device memory held by the CUDA graphs' private pools: the segments
    of the allocator's snapshot outside the default pool."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def _launches_per_call(fn) -> int:
    """The kernels one call of ``fn()`` launches, counted exactly: the
    kernel nodes of the call captured into a graph (a profiler's trace
    drops a record now and then)."""
    return sum(_graph_kernels(fn).values())


def _graph_kernels(fn) -> dict:
    """The kernel nodes by name of a CUDA graph captured from ``fn()``: the
    launches of ``fn`` on the card, each one node, none lost (the wrappers'
    counters are left as they were: the capture launched nothing)."""
    import torch

    from ldm_tf2_tpu_torch import graphs

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = graphs.counts()
    with torch.cuda.graph(graph):
        fn()
    graphs.add_counts(graphs.rise(before, graphs.counts()), -1)  # a capture launches nothing
    names = dict(graphs.graph_kernels(graph))
    del graph
    return names


def _eval_pair(unet, shape, what: str, cache_levels: int | None = None) -> None:
    """One U-Net eval at the CFG batch of latent ``shape``, eager and
    through ``graphs.graphed_eps_model``: the replay bit-equal to the eager
    eval, the wrappers' counts of one graphed eval (read off its graph's
    kernel nodes) equal to one eager eval's, and the graph's kernel nodes by
    name equal to those of the eager eval captured into a graph of its own
    (the launches of the eager eval, exactly).  Then wall ms per eval timed
    bare in turns (eager, graphed, graphed, eager), and one profiled window
    of each: busy ms, idle share, and the launches the trace recorded
    (a window can lose records: they are reported beside the graph's count,
    not held to it).  ``cache_levels``: the shallow pass, fed a fresh cache."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldm_tf2_tpu_torch import graphs as shared
    from ldm_tf2_tpu_torch.diffusion import graphs

    gen = torch.Generator(device="cuda").manual_seed(5)
    b2 = 2 * shape[0]
    x = torch.randn((b2, *shape[1:]), generator=gen, device="cuda", dtype=unet.dtype)
    t = torch.full((b2,), 501.0, device="cuda")
    ctx = torch.randn(b2, 77, 1280, generator=gen, device="cuda", dtype=unet.dtype) * 0.05
    n_bare, n_prof = GRAPHS_EVALS
    out = {}
    with torch.inference_mode():
        kw = {}
        if cache_levels:
            cache = unet(x, t, ctx, return_cache=True, cache_levels=cache_levels)[1]
            kw = dict(shallow_cache=cache, cache_levels=cache_levels)
        model = graphs.graphed_eps_model(unet)
        fns = {"eager": lambda: unet(x, t, ctx, **kw), "graphed": lambda: model(x, t, ctx, **kw)}
        want = fns["eager"]()
        for name, fn in fns.items():
            fn()  # the graphed model's capture, if its key is new
            before = shared.counts()
            got = fn()
            out[name] = {"counts": shared.rise(before, shared.counts())}
            check(torch.equal(got, want), f"{what}: the {name} eval differs from the eager one")
        check(out["graphed"]["counts"] == out["eager"]["counts"],
              f"{what}: a replay counts {out['graphed']['counts']}, an eager eval "
              f"{out['eager']['counts']}")
        replayed = dict(graphs.STORE.kernels(model.key(x, t, ctx, **kw)))
        eager_nodes = _graph_kernels(fns["eager"])
        walls = {"eager": [], "graphed": []}
        for name in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(n_bare):
                fns[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - start) * 1e3 / n_bare)
        for name, fn in fns.items():
            wall = statistics.mean(walls[name])
            # the device's activity only: the host's ops would add 10-15 s
            # of the profiler's own processing to an eager window
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                for _ in range(n_prof):
                    fn()
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - start) * 1e3
            rep = _profile_report(prof, n_prof, f"{name} {what}", prof_ms, wall * n_prof)
            check(rep is not None, f"{what}: the profiler recorded no device time")
            out[name].update(wall_ms=wall, walls=walls[name], busy_ms=rep["busy_ms"],
                             seen=rep["launches"] - rep["copies"], copies=rep["copies"],
                             idle=1 - rep["busy_ms"] / wall)
    e, g = out["eager"], out["graphed"]
    n_nodes = sum(replayed.values())
    log(f"graphs: {what} at CFG batch {b2}: wall per eval eager {e['wall_ms']:.2f} ms "
        f"{[round(w, 2) for w in e['walls']]}, graphed {g['wall_ms']:.2f} ms "
        f"{[round(w, 2) for w in g['walls']]} ({e['wall_ms'] / g['wall_ms']:.2f}x); device "
        f"busy {e['busy_ms']:.2f} / {g['busy_ms']:.2f} ms, idle share {e['idle']:.1%} / "
        f"{g['idle']:.1%}; kernel launches per eval: the replayed graph's kernel nodes "
        f"{n_nodes} ({len(replayed)} kernels), the eager eval's {sum(eager_nodes.values())} "
        f"(captured), the traces recorded {e['seen']:.2f} / {g['seen']:.2f} (copies and "
        f"memsets {e['copies']:.2f} / {g['copies']:.2f}); counters per eval equal, replay "
        f"bit-equal")
    if replayed != eager_nodes:
        names = set(replayed) | set(eager_nodes)
        check(False, f"{what}: kernel nodes by name differ (replayed graph, eager eval): "
              + "; ".join(f"{k[:80]} {replayed.get(k, 0)}, {eager_nodes.get(k, 0)}"
                          for k in sorted(names) if replayed.get(k, 0) != eager_nodes.get(k, 0)))


def phase_graphs(card: str, run: dict) -> None:
    """The sampling path's U-Net evals captured as CUDA graphs and replayed
    (``diffusion/graphs.py``), each run beside its eager run
    (``graphs=False``) with the same seed and weights: the main path (50
    CFG DDIM steps, batch 2, bf16) in turns (eager, graphed, graphed,
    eager), the same call at ``GRAPHS_HEADLINE_BATCH``, the opt-in route
    and one img2img call (PLMS, DPM-Solver++(2M), DDPM and DDIM DeepCache
    are held to their eager calls in ``phase_serve_program``, where the
    server's calls are one graph each).  Each pair: x0 and images bit-equal, the launch
    counts per call equal, s per call and peak memory allocated each side
    (a graph's temporaries live in its pool, outside that count), the
    graphs' pools' size, the seconds of every new capture (its eager
    warm-up eval included).  ``_eval_pair`` profiles one eval of each
    route (default at batch 2 and 24, opt-in, int8, the DeepCache shallow
    pass)."""
    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_img2img, sample_txt2img
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.diffusion import graphs
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    start_phase = time.perf_counter()
    models, ids, shape, kwargs = run["models"], run["ids"], run["shape"], run["kwargs"]
    unet, autoencoder = models[1], models[2]
    unet.set_serving_modes()
    autoencoder.set_serving_modes()
    config = run["config"]
    sampling, ldm = config["ldm_sampling"], config["ldm"]
    schedule = factory.build_schedule(config)
    steps = schedule.num_ddim_steps
    base = dict(num_steps=ldm["num_steps"], beta_start=ldm["beta_start"],
                beta_end=ldm["beta_end"], num_ddim_steps=steps)
    short = make_schedule(**{**base, "num_ddim_steps": 2})
    store = graphs.STORE
    counters = _counters()

    def one(fn, on):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        start = time.perf_counter()
        outs = fn(on)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = {k: v for k, v in _read(counters).items() if v}
        return (seconds, counts, [o.float().cpu() if torch.is_tensor(o) else o for o in outs],
                torch.cuda.max_memory_allocated() / 1e9, _graph_pool_gb())

    def pair(name, fn, evals, warm=None, order=(False, True, True, False)):
        """``fn(graphs) -> outputs`` eager and graphed in the turns of
        ``order``, after ``warm(True)`` (a short graphed call that captures
        the run's keys), each output held bit-equal to the first eager
        run's."""
        n0 = len(store.capture_seconds)
        if warm is not None:
            warm(True)
        runs = {False: [], True: []}
        for on in order:
            runs[on].append(one(fn, on))
        captured = store.capture_seconds[n0:]
        ref = runs[False][0]
        for on, got in ((on, r) for on in runs for r in runs[on]):
            for i, (a, b) in enumerate(zip(got[2], ref[2])):
                same = (torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(a, b))
                if not same:
                    diff = float((torch.as_tensor(a).float() - torch.as_tensor(b).float())
                                 .abs().max())
                    check(False, f"graphs {name}: output {i} of a "
                                 f"{'graphed' if on else 'eager'} run differs from the first "
                                 f"eager run, max abs {diff:.3e}")
            check(got[1] == ref[1], f"graphs {name}: launches {got[1]} against eager {ref[1]}")
        e_s = statistics.mean(r[0] for r in runs[False])
        g_s = statistics.mean(r[0] for r in runs[True])
        peak = (max(r[3] for r in runs[False]), max(r[3] for r in runs[True]))
        pool = max(r[4] for r in runs[True])
        log(f"graphs: {name} on {card}: {evals} U-Net evals a call, s per call eager "
            f"{[round(r[0], 3) for r in runs[False]]}, graphed "
            f"{[round(r[0], 3) for r in runs[True]]} ({e_s / g_s:.2f}x), per eval "
            f"{e_s / evals * 1e3:.2f} / {g_s / evals * 1e3:.2f} ms (encode and decode "
            f"included); x0 and images bit-equal PASS; launches per call equal PASS "
            f"{ref[1]}; peak allocated eager {peak[0]:.2f} GB, graphed {peak[1]:.2f} GB, "
            f"the graphs' pools {pool:.2f} GB; {len(captured)} capture(s) "
            f"{[round(c, 3) for c in captured]} s")

    def txt2img(sched, ids_=ids, shape_=shape, **kw):
        return lambda on: sample_txt2img(*models, sched, ids_, shape_, graphs=on,
                                         **{**kwargs, **kw})

    # the main path
    pair("main path, DDIM", txt2img(schedule), steps, warm=txt2img(short))
    _eval_pair(unet, shape, "default bf16 eval")
    # bench.py's headline batch
    tokenizer = load_tokenizer(os.path.join(ROOT, sampling["vocab_dir"]))
    hb = GRAPHS_HEADLINE_BATCH
    ids24 = torch.as_tensor(cfg_token_ids(tokenizer, sampling["text_prompt"], hb, 77))
    shape24 = (hb,) + tuple(shape[1:])
    pair(f"headline, DDIM, batch {hb}", txt2img(schedule, ids24, shape24), steps,
         warm=txt2img(short, ids24, shape24), order=(False, True))
    _eval_pair(unet, shape24, f"default bf16 eval, batch {hb}")
    # PLMS, DPM-Solver++(2M), DDPM and DeepCache: the per-eval graphed call
    # against the eager one in phase_serve_program, at batch 4
    _eval_pair(unet, shape, "DeepCache shallow eval", cache_levels=1)
    # img2img at strength 0.75: 38 steps
    pixels = np.random.default_rng(11).integers(0, 256, (shape[0], 256, 256, 3), np.uint8)
    init_image = pixels.astype(np.float32) / 127.5 - 1.0
    t_enc = int(round(0.75 * steps))
    pair("img2img, strength 0.75",
         lambda on: sample_img2img(*models, schedule, ids, init_image, strength=0.75,
                                   graphs=on, **kwargs), t_enc, order=(False, True))
    # the opt-in route
    _set_switches("pallas", "pallas", True)
    try:
        pair("opt-in route, DDIM", txt2img(schedule), steps, warm=txt2img(short),
             order=(False, True))
        _eval_pair(unet, shape, "opt-in bf16 eval")
    finally:
        _set_switches("auto", "auto", False)
    unet.set_serving_modes(conv_quant=True, attention_pv_int8=True)
    try:
        _eval_pair(unet, (4,) + tuple(shape[1:]), "int8 + int8-P.V eval")
    finally:
        unet.set_serving_modes()
        autoencoder.set_serving_modes()
    graphs.STORE.clear()
    torch.cuda.empty_cache()
    log(f"graphs: phase took {time.perf_counter() - start_phase:.1f} s on {card}")


# The serve program phase's configurations, batch 4 (CFG 8), 256^2, one
# card: (name, tpu serving modes, ldm_sampling keys, ldm keys, whether a
# replay is profiled); PLMS at phase_samplers' 50 steps, DDPM on its
# 100-step timeline.  A profiler window costs about 0.16 ms of host time a
# kernel (42 s for DDPM's 262,524): the bf16 DDIM, DeepCache, PLMS and
# DDPM replays, whose evals are the profiled bf16 ones, go unprofiled to
# keep the script in its time limit
SERVE_PROGRAM_CONFIGS = (
    ("int8 + int8-P.V DDIM, 50 steps", dict(quantize="int8", quantize_attention="int8pv"),
     {}, {}, True),
    ("bf16 DDIM, 50 steps", {}, {}, {}, False),
    ("bf16 DDIM eta 1, 10 steps", {}, {}, dict(eta=1.0, num_ddim_steps=10), True),
    ("bf16 DDIM DeepCache, interval 3", {}, dict(cache_interval=3), {}, False),
    ("bf16 DPM-Solver++(2M), 8 karras steps", {}, dict(sampler="dpm_solver_pp_2m"),
     dict(num_ddim_steps=8, timestep_spacing="karras"), True),
    ("bf16 PLMS, 50 steps", {}, dict(sampler="plms"), {}, False),
    ("bf16 DDPM, T = 100", {}, dict(sampler="ddpm"), dict(num_steps=100), False),
)
# The calls after a program's warm-up (which takes the first's inputs):
# two seeds, two per-slot guidance vectors
SERVE_PROGRAM_CALLS = ((1, (5.0, 7.5, 3.0, 5.0)), (2, (5.0, 7.5, 3.0, 5.0)),
                       (1, (2.0, 9.0, 5.0, 4.5)))
SERVE_PROGRAM_PROMPTS = ["a virus monster is playing guitar", "an oil painting of a harbour",
                         "a red fox", "a lighthouse at dusk"]


def _program_config(tpu: dict, sampling: dict, ldm: dict) -> dict:
    """The north star at batch 4 with ``tpu``'s serving modes and the
    sampling and schedule keys given."""
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(NORTH_STAR))
    config["ldm_sampling"].update(latent_shape=[4, 32, 32, 4],
                                  vocab_dir=os.path.join(ROOT, "bert_model"), **sampling)
    config["ldm"].update(ldm)
    config["tpu"].update(tpu)
    return validate(config)


def _program_ids():
    """The token ids [8, 77] of ``SERVE_PROGRAM_PROMPTS`` on the card."""
    import torch

    from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer, packed_cfg_token_ids

    tokenizer = load_tokenizer(os.path.join(ROOT, "bert_model"))
    return torch.as_tensor(packed_cfg_token_ids(tokenizer, SERVE_PROGRAM_PROMPTS,
                                                [""] * 4, 77), device="cuda")


def _timed(fn):
    """(seconds, fn()) with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - start, out


def _window(fn, n: int, what: str, bare_ms: float) -> dict:
    """``n`` calls of ``fn`` in one CUDA-only profiler window:
    ``_profile_report``'s busy ms, launches and copies per call, beside
    ``bare_ms``, the wall of a call without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - start) * 1e3
    rep = _profile_report(prof, n, what, prof_ms, bare_ms * n)
    check(rep is not None, f"{what}: the profiler recorded no device time")
    return rep


def phase_encode_decode(card: str, models, ids) -> dict:
    """The eager text encode of a batch-4 serving call (token ids [8, 77])
    and its eager decode (latents [4, 32, 32, 4] to [4, 256, 256, 3]), in
    bf16 and with the decoder's attention in int8 P.V: wall ms per call
    (the mean of 5, bare) and one CUDA-only profiler window of 3 calls each
    (busy ms, idle share, time by kernel group)."""
    import torch

    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import decode_latents

    cond, _, autoencoder = models
    gen = torch.Generator(device="cuda").manual_seed(31)
    z = torch.randn(4, 32, 32, 4, generator=gen, device="cuda") / 0.18215
    out = {}
    runs = (("text encode", lambda: cond(ids), False),
            ("decode, bf16 attention", lambda: decode_latents(autoencoder, z), False),
            ("decode, int8-P.V attention", lambda: decode_latents(autoencoder, z), True))
    try:
        with torch.inference_mode():
            for what, fn, pv8 in runs:
                autoencoder.set_serving_modes(attention_pv_int8=pv8)
                fn()
                walls = [_timed(fn)[0] * 1e3 for _ in range(5)]
                wall = statistics.mean(walls)
                rep = _window(fn, 3, f"eager {what} at batch 4", wall)
                out[what] = dict(wall_ms=wall, busy_ms=rep["busy_ms"],
                                 idle=1 - rep["busy_ms"] / wall)
                log(f"encode / decode on {card}: eager {what}, batch 4: wall "
                    f"{wall:.2f} ms {[round(w, 2) for w in walls]}, busy "
                    f"{rep['busy_ms']:.2f} ms in {rep['launches']:.0f} launches, idle "
                    f"{out[what]['idle']:.1%}")
    finally:
        autoencoder.set_serving_modes()
    return out


def _on_wgmma(rise: dict) -> dict:
    """The counted launches of ``rise`` (a ``graphs.rise``) by path that
    are not on ``wgmma`` (a plan's modes left out)."""
    from ldm_tf2_tpu_torch import graphs as shared

    modes = [name for name, paths in shared._KERNELS.items() if None in paths]
    return {fn.__name__: paths for (fn, attr), paths in rise.items()
            if attr == "launches_by_path" and fn.__name__ not in modes
            and sum(paths.values()) != paths.get("wgmma", 0)}


@contextlib.contextmanager
def _served_images(seen: list):
    """The server's float images, as its ``run_batch`` hands them to
    ``tensor_to_image`` on their way to uint8, appended to ``seen``."""
    from ldm_tf2_tpu_torch.cli import serve_ldm

    real = serve_ldm.tensor_to_image
    serve_ldm.tensor_to_image = lambda images: seen.append(images.copy()) or real(images)
    try:
        yield seen
    finally:
        serve_ldm.tensor_to_image = real


# Host seconds of the program's weights check, timed over this many calls
STAMP_CALLS = 20


def phase_serve_program(card: str, models) -> None:
    """The server's call as one CUDA graph (``diffusion/graphs.py::
    SamplingProgram``), at the north-star widths, batch 4, 256^2, on one
    card, for each of ``SERVE_PROGRAM_CONFIGS``, through the server's own
    ``run_batch`` (``cli/serve_ldm.py::build_server``: its settings, its
    token ids, guidance and seed), its float images read where it turns
    them to uint8: the eager encode and decode first
    (``phase_encode_decode``); then per configuration the eager server's
    call (``graphs=False``, on the first of ``SERVE_PROGRAM_CALLS``) and the
    per-eval graphed call (``sample_txt2img(..., graphs=True)`` with the
    server's settings, on each call), the program's warm-up (its one
    capture, on the first call's inputs) and a replay on each call: images
    bit-equal among the three, a replay's launch counts equal to the
    per-eval graphed call's (read off the graph's kernel nodes) and every
    counted launch on ``wgmma``; s per call each way, the capture's seconds
    (eager warm-up call included), the graph's kernel nodes, peak allocated
    in the replays beside the graph pool, the host's ms of the program's
    weights check a call (``STAMP_CALLS`` timed), and, where the
    configuration says so, one replay in a CUDA-only profiler window (busy
    ms, idle share).  Then one U-Net tensor replaced: the next call
    captures anew, bit-equal to the replays before."""
    import io

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch import graphs as shared
    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img
    from ldm_tf2_tpu_torch.diffusion import graphs

    start_phase = time.perf_counter()
    store = graphs.STORE
    store.clear()
    ids = _program_ids()
    phase_encode_decode(card, models, ids)
    unet = models[1]
    prompts, negatives = SERVE_PROGRAM_PROMPTS, [""] * len(SERVE_PROGRAM_PROMPTS)

    def counted(fn):
        before = shared.counts()
        seconds, out = _timed(fn)
        return seconds, out, shared.rise(before, shared.counts())

    def served(run_batch, seed, guidance):
        """(seconds, float images, counts) of one server call."""
        seen = []
        with _served_images(seen):
            seconds, _, rise = counted(lambda: run_batch(prompts, negatives, list(guidance),
                                                         seed))
        return seconds, seen[0], rise

    for n_config, (name, tpu, sampling, ldm, profiled) in enumerate(SERVE_PROGRAM_CONFIGS):
        config = _program_config(tpu, sampling, ldm)
        with contextlib.redirect_stderr(io.StringIO()):
            eager_batch, _, _ = serve_ldm.build_server(config, device="cuda", models=models,
                                                       graphs=False)
            run_batch, _, _ = serve_ldm.build_server(config, device="cuda", models=models)
        program, settings = run_batch.program, run_batch.settings
        check(eager_batch.program is None and program is not None,
              f"serve program {name}: the server on one card made no program, or its "
              "graphs=False twin made one")
        schedule = factory.build_schedule(config)
        shape = tuple(config["ldm_sampling"]["latent_shape"])
        evals = (schedule.num_steps if settings["sampler"] == "ddpm"
                 else len(schedule.ddim_steps))
        calls = SERVE_PROGRAM_CALLS

        def per_eval(seed, guidance):
            g = torch.tensor(guidance, device="cuda").reshape(len(guidance), 1, 1, 1)
            images, _ = sample_txt2img(*models, schedule, ids, shape, guidance_scale=g,
                                       seed=seed, device="cuda", graphs=True, **settings)
            return images.float().cpu().numpy()

        start_config = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        refs = {"eager": [served(eager_batch, *calls[0])]}
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode():
            refs["per-eval graphed"] = [counted(lambda: per_eval(*c)) for c in calls]
        made, replays = len(store.capture_seconds), store.replays
        warm = served(run_batch, *calls[0])
        torch.cuda.reset_peak_memory_stats()
        got = [served(run_batch, *c) for c in calls]
        peak, pool = torch.cuda.max_memory_allocated() / 1e9, _graph_pool_gb()
        made, replays = len(store.capture_seconds) - made, store.replays - replays
        # a call's graphs: one, or DDPM's encode, runs of DDPM_RUN_STEPS and decode
        graphed = program.last_graphs
        per_call = sum(graphed.values())
        check(made == len(graphed) and replays == (len(calls) + 1) * per_call - made,
              f"serve program {name}: {made} capture(s), {replays} replay(s) for "
              f"{len(graphed)} graph(s) replayed {per_call} times a call")
        capture_s = sum(store.capture_seconds[-made:])
        nodes = program.call_nodes()
        graph_nodes = [sum(store.kernels(k).values()) for k in graphed]
        for i, ref in enumerate(refs["per-eval graphed"]):
            runs = [("replay", got[i])]
            if i == 0:
                runs += [("warm-up", warm), ("eager server", refs["eager"][0])]
            for way, run in runs:
                check(np.array_equal(run[1], ref[1]), f"serve program {name}: the images of "
                      f"the {way} call {i} differ from the per-eval graphed call's, max abs "
                      f"{float(np.abs(run[1] - ref[1]).max()):.3e}")
                check(run[2] == ref[2], f"serve program {name}: the {way} call {i} counts "
                                        f"{run[2]}, the per-eval graphed call {ref[2]}")
            off = _on_wgmma(got[i][2])
            check(not off, f"serve program {name}: launches off wgmma {off}")
        check(not np.array_equal(got[0][1], got[1][1])
              and not np.array_equal(got[0][1], got[2][1]),
              f"serve program {name}: another seed or guidance gave the same images")
        tensors = len(shared.module_tensors(*program.models))
        start_stamp = time.perf_counter()
        for _ in range(STAMP_CALLS):
            store.check_weights(program, shared.stamp(shared.module_tensors(*program.models)))
        stamp_ms = (time.perf_counter() - start_stamp) * 1e3 / STAMP_CALLS
        secs = {way: [r[0] for r in refs[way]] for way in refs}
        secs["program"] = [r[0] for r in got]
        mean = {way: statistics.mean(v) for way, v in secs.items()}
        busy = "replay not profiled"
        if profiled:
            start_window = time.perf_counter()
            seed, guidance = calls[1]
            rep = _window(lambda: run_batch(prompts, negatives, list(guidance), seed),
                          1, f"program replay, {name}", mean["program"] * 1e3)
            busy = (f"replay busy {rep['busy_ms']:.2f} ms, idle "
                    f"{1 - rep['busy_ms'] / (mean['program'] * 1e3):.1%} (the window "
                    f"{time.perf_counter() - start_window:.1f} s)")
        counts = {fn.__name__: n for (fn, attr), n in got[0][2].items() if attr == "launches"}
        log(f"serve program on {card}: {name}, {evals} U-Net evals a call, through the "
            f"server's run_batch: s per call eager server "
            f"{[round(x, 4) for x in secs['eager']]}, per-eval graphed "
            f"{[round(x, 4) for x in secs['per-eval graphed']]}, program replay "
            f"{[round(x, 4) for x in secs['program']]} (eager / program "
            f"{mean['eager'] / mean['program']:.2f}x, per-eval / program "
            f"{mean['per-eval graphed'] / mean['program']:.2f}x); {busy}; the weights check "
            f"{stamp_ms:.3f} ms a call over {tensors} tensors; warm-up call "
            f"{warm[0]:.3f} s, capture {capture_s:.3f} s (eager warm-up call "
            f"included), {nodes} kernel nodes a call in {len(graphed)} graph(s) of "
            f"{graph_nodes} nodes replayed {list(graphed.values())} times; peak allocated "
            f"eager {eager_peak:.2f} GB, "
            f"in the replays {peak:.2f} GB, graph pool {pool:.2f} GB; images bit-equal "
            f"(warm-up, 3 replays, eager server, per-eval graphed) PASS; launches a "
            f"replay {counts}, equal to the per-eval graphed call's, on wgmma PASS; the "
            f"configuration took {time.perf_counter() - start_config:.1f} s")
        if n_config == 4:  # a cheap capture: one U-Net tensor replaced
            old = unet.conv_out.bias
            unet.conv_out.bias = torch.nn.Parameter(old.detach().clone(), requires_grad=False)
            try:
                made = len(store.capture_seconds)
                again = served(run_batch, *calls[0])
                check(len(store.capture_seconds) == made + 1,
                      f"serve program: a replaced U-Net tensor made "
                      f"{len(store.capture_seconds) - made} captures, expected 1")
                check(np.array_equal(again[1], got[0][1]),
                      "serve program: the recaptured call differs")
                log(f"serve program: a replaced U-Net tensor (conv_out.bias) dropped the "
                    f"capture; the next call captured anew in {store.capture_seconds[-1]:.3f}"
                    f" s, bit-equal PASS")
            finally:
                unet.conv_out.bias = old
        del run_batch, eager_batch, program
        store.clear()
        torch.cuda.empty_cache()
    unet.set_serving_modes()
    models[2].set_serving_modes()
    log(f"serve program: phase took {time.perf_counter() - start_phase:.1f} s on {card}")


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
    pool_gb = _graph_pool_gb()
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
        f"peak memory allocated {peak_gb:.2f} GB, graph pool {pool_gb:.2f} GB beside it; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; "
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


# Train-graphs phase: K eager and K graphed steps from one start, the steps
# of each profiled window, and the extra LDM runs (gradient accumulation,
# remat "blocks") with their steps
TRAIN_GRAPH_STEPS = 4
TRAIN_GRAPH_PROFILED = 3
TRAIN_GRAPH_EXTRA = {"grad_accum_steps 2": (dict(accum_steps=2), False, 4),
                     'remat "blocks"': ({}, "blocks", 3)}


def _step_kernels(program, state, inputs) -> dict:
    """The kernel nodes by name of one eager step of ``program`` (a
    ``StepProgram``) captured into a graph of its own, its draws from
    generators registered with it: the step's launches on the card, each
    one node (the capture runs nothing and leaves the counters as they
    were)."""
    import torch

    from ldm_tf2_tpu_torch import graphs
    from ldm_tf2_tpu_torch.training.ldm_trainer import device_scalars

    gens = [torch.Generator(device="cuda") for _ in range(program.generators)]
    hyper = device_scalars(program.hyper(state), "cuda")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in gens:
        graph.register_generator_state(gen)
    before = graphs.counts()
    with torch.cuda.graph(graph):
        program.body(state, gens, hyper, program.phase(state), *inputs)
    graphs.add_counts(graphs.rise(before, graphs.counts()), -1)
    names = dict(graphs.graph_kernels(graph))
    del graph
    torch.cuda.empty_cache()
    return names


def _host_copy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _max_diff(got: dict, want: dict) -> float:
    """The largest |got - want| over every tensor (on the card, one at a
    time)."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k].to("cuda", torch.float64)
        worst = max(worst, float((g - w.to("cuda", torch.float64)).abs().max()))
    return worst


def _graphed_vs_eager(card: str, what: str, build, inputs, steps: int,
                      profiled: int = 0) -> dict:
    """``steps`` steps of ``build()``'s program (``build() -> (program,
    state, snapshot)``, each call from the same start) eagerly, then graphed
    through a store of its own, cuDNN deterministic: the metrics and
    ``snapshot(state)`` (parameters, moments, EMA, running statistics) bit-
    equal, or else within a second eager run's own difference from the
    first (printed); the launch counts of the two runs equal; the replayed
    graph's kernel nodes by name equal to the eager step's captured into a
    graph.  s/step (median of the steps after the first), peak allocated
    memory, the graph pool's GB and the capture seconds; with ``profiled``,
    busy ms and idle share over a CUDA-only profiler window of that many
    more steps each.  Returns the report."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldm_tf2_tpu_torch import graphs
    from ldm_tf2_tpu_torch.training.graphs import graphed_train_step

    store = graphs.GraphStore()
    out, host = {}, {}
    with _DeterministicCudnn():
        for mode in ("eager", "graphed", "eager again"):
            if mode == "eager again" and out["graphed"]["same"]:
                break
            torch.cuda.empty_cache()
            program, state, snapshot = build()
            step = graphed_train_step(program, store) if mode == "graphed" else program
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = graphs.counts()
            metrics, walls = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, *inputs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
            rep = dict(metrics=metrics, walls=walls, s_step=statistics.median(walls[1:]),
                       counts=graphs.rise(before, graphs.counts()),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            snap = snapshot(state)
            if mode == "eager":
                host = _host_copy(snap)
                rep["same"] = True
                if profiled:
                    rep["nodes"] = _step_kernels(program, state, inputs)
            elif mode == "graphed":
                rep["same"] = metrics == out["eager"]["metrics"] and all(
                    torch.equal(v, host[k].to("cuda")) for k, v in snap.items())
                rep.update(pool_gb=_graph_pool_gb(), capture_s=list(store.capture_seconds),
                           per_replay={f"{fn.__name__}.{attr}": n for (fn, attr), n in
                                       next(iter(store._entries.values())).rise.items()
                                       if attr == "launches"})
                if not rep["same"]:
                    rep["diff"] = _max_diff(snap, host)
                    host_graphed = _host_copy(snap)
                replayed = {k: dict(store.kernels(k)) for k in store._entries}
                rep["nodes"] = replayed
            else:
                rep["diff"] = _max_diff(snap, host)
                rep["graphed_vs_again"] = _max_diff(host_graphed, _host_copy(snap))
            if profiled and mode != "eager again":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(profiled):
                        state, _ = step(state, *inputs)
                    torch.cuda.synchronize()
                    prof_ms = (time.perf_counter() - t0) * 1e3
                bare = rep["s_step"] * 1e3 * profiled
                prof_rep = _profile_report(prof, profiled, f"{mode} {what}", prof_ms, bare)
                check(prof_rep is not None, f"{what}: the profiler recorded no device time")
                rep.update(busy_ms=prof_rep["busy_ms"],
                           idle=1 - prof_rep["busy_ms"] / (rep["s_step"] * 1e3))
            out[mode] = rep
            del program, state, snapshot, step, snap
        store.clear()
    torch.cuda.empty_cache()
    e, g = out["eager"], out["graphed"]
    counts_equal = e["counts"] == g["counts"]
    if g["same"]:
        same = "bit-equal"
        ok = True
    else:
        again = out["eager again"]
        same = (f"NOT bit-equal: graphed vs eager max |diff| {g['diff']:.3e}, a second "
                f"eager run vs the first {again['diff']:.3e} (the bound: the eager path's "
                f"own run-to-run difference), graphed vs the second {again['graphed_vs_again']:.3e}")
        ok = again["diff"] > 0 and g["diff"] <= again["diff"]
    line = (f"train graphs {what} on {card}: {steps} steps each from one start: eager "
            f"{e['s_step']:.4f} s/step ({', '.join(f'{w:.4f}' for w in e['walls'])}), "
            f"graphed {g['s_step']:.4f} s/step ({', '.join(f'{w:.4f}' for w in g['walls'])}; "
            f"the first: eager warm-up and capture), {e['s_step'] / g['s_step']:.2f}x; "
            f"capture s {[round(c, 3) for c in g['capture_s']]}; peak allocated "
            f"{e['peak_gb']:.2f} GB eager, {g['peak_gb']:.2f} GB graphed; graph pool "
            f"{g['pool_gb']:.2f} GB; losses and state {same}; launch counts equal "
            f"{counts_equal}; per replay {g['per_replay']}")
    if profiled:
        line += (f"; device busy {e['busy_ms']:.2f} / {g['busy_ms']:.2f} ms a step, idle "
                 f"share {e['idle']:.1%} / {g['idle']:.1%} (eager / graphed)")
        (replayed,) = g["nodes"].values()
        line += (f"; kernel nodes a step: replayed graph {sum(replayed.values())} "
                 f"({len(replayed)} kernels), eager step captured "
                 f"{sum(e['nodes'].values())}")
        if replayed != e["nodes"]:
            names = set(replayed) | set(e["nodes"])
            check(False, f"{what}: kernel nodes by name differ (replayed graph, eager step): "
                  + "; ".join(f"{k[:80]} {replayed.get(k, 0)}, {e['nodes'].get(k, 0)}"
                              for k in sorted(names)
                              if replayed.get(k, 0) != e["nodes"].get(k, 0)))
    log(line + (" PASS" if ok and counts_equal else " FAIL"))
    check(ok and counts_equal, f"train graphs {what}: {same}; counts {e['counts']} eager, "
          f"{g['counts']} graphed")
    return out


def phase_train_graphs(card: str, models) -> dict:
    """The train steps captured as CUDA graphs and replayed
    (``training/graphs.py``), each beside the eager step from the same
    start (``_graphed_vs_eager``): the LDM step at the north star (batch 8,
    256^2, bf16 over float32 masters, EMA, clip 1.0), then with
    ``grad_accum_steps: 2`` and with remat "blocks"; the VQ autoencoder's
    GAN step at batch 3 and the KL autoencoder's phase-1 step.  Rows 1-3's
    launches a step, read off the replayed graph's nodes, are held to
    ``TRAIN_STEP`` and ``AE_STEP_ATTENTIONS``.  Returns rows 1-3's
    launches per replayed LDM step."""
    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.data.tokenizer import null_condition_ids
    from ldm_tf2_tpu_torch.training import ae_trainer as at
    from ldm_tf2_tpu_torch.training import ldm_trainer as lt

    start = time.perf_counter()
    config = _train_config(8, 256)
    cond, unet, ae = models
    s0 = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(87)
    images = torch.as_tensor(rng.uniform(-1, 1, (8, 256, 256, 3)), dtype=torch.bfloat16,
                             device="cuda")
    ids = torch.as_tensor(rng.integers(1000, 30000, (8, 77)), device="cuda")
    schedule = factory.build_schedule(config)

    def ldm(opt_kw=None, remat=False):
        def build():
            unet.load_state_dict(s0)
            opt = lt.make_optimizer(learning_rate=5e-5, clip_grad_norm=1.0, **(opt_kw or {}))
            program = lt.make_ldm_train_step(
                unet, cond, ae, schedule, opt, condition_dropout_rate=0.1,
                null_token_ids=null_condition_ids(1, 77)[0], remat_unet=remat,
                ema_decay=0.9999, seed=88)
            state = lt.init_ldm_train_state(unet, cond, opt, ema_decay=0.9999)

            def snapshot(state):
                snap = {f"unet.{k}": p for k, p in unet.named_parameters()}
                for part in ("mu", "nu", "acc"):
                    snap.update({f"{part}.{k}": t for k, t in
                                 state.opt_state.get(part, {}).items()})
                snap.update({f"ema.{k}": t for k, t in state.ema.items()})
                return snap

            return program, state, snapshot
        return build

    try:
        ldm_report = _graphed_vs_eager(card, "LDM step, batch 8, 256^2, bf16, EMA, clip 1.0",
                                 ldm(), (images, ids), TRAIN_GRAPH_STEPS,
                                 TRAIN_GRAPH_PROFILED)
        for what, (opt_kw, remat, steps) in TRAIN_GRAPH_EXTRA.items():
            _graphed_vs_eager(card, f"LDM step, {what}", ldm(opt_kw, remat), (images, ids),
                              steps)
    finally:
        unet.load_state_dict(s0)
    per_replay = ldm_report["graphed"]["per_replay"]
    want = {f"{k}.launches": v for k, v in TRAIN_STEP.items() if v}
    got = {k: per_replay.get(k, 0) for k in want}
    check(got == want, f"train graphs: a replayed LDM step launches {got}, want {want}")
    del images, ids
    torch.cuda.empty_cache()

    for ae_type, phase, seed in (("vq", 2, 89), ("kl", 1, 90)):
        ae_config = _ae_config(ae_type)
        trainer = ae_config[f"autoencoder_{ae_type}_trainer"]
        ae_models = _ae_models(ae_config, "cuda", seed)
        weights = [{k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                   for m in ae_models[:2]]
        ae_images = torch.as_tensor(rng.uniform(-1, 1, (3, 256, 256, 3)),
                                    dtype=torch.float32, device="cuda")

        def build():
            auto, disc, lpips = ae_models
            for m, w in zip((auto, disc), weights):
                m.load_state_dict(w)
            auto.requires_grad_(True).train()
            disc.requires_grad_(True).train()
            lpips.requires_grad_(False)
            ae_opt = at.make_adam(**ae_config["autoencoder_optimizer"])
            d_opt = at.make_adam(**ae_config["discriminator_optimizer"])
            steps = at.make_ae_train_steps(
                auto, disc, lpips, ae_opt, d_opt, lpips_weight=trainer["lpips_weight"],
                regularization_weight=trainer["kl_weight" if ae_type == "kl"
                                              else "codebook_weight"],
                discriminator_weight=trainer["discriminator_weight"],
                discriminator_factor=trainer["discriminator_factor"], seed=seed)
            state = at.init_ae_train_state(auto, disc, ae_opt, d_opt)

            def snapshot(state):
                snap = {f"ae.{k}": v for k, v in auto.state_dict().items()}
                snap.update({f"d.{k}": v for k, v in disc.state_dict().items()})
                for name in ("ae_opt_state", "d_opt_state"):
                    for part in ("mu", "nu"):
                        snap.update({f"{name}.{part}.{k}": t for k, t in
                                     getattr(state, name)[part].items()})
                return snap

            return steps[phase - 1], state, snapshot

        what = (f"{ae_type.upper()} autoencoder "
                f"{'GAN step' if phase == 2 else 'phase-1 step'}, batch 3, 256^2, bf16")
        report = _graphed_vs_eager(card, what, build, (ae_images,), TRAIN_GRAPH_STEPS,
                                   TRAIN_GRAPH_PROFILED if ae_type == "vq" else 0)
        per_replay = report["graphed"]["per_replay"]
        n = AE_STEP_ATTENTIONS[ae_type]
        want = {f"{k}.launches": n for k in ("flash_attention", "flash_backward_dq",
                                              "flash_backward_dkv")}
        got = {k: per_replay.get(k, 0) for k in want}
        check(got == want, f"train graphs {what}: a replay launches {got}, want {want}")
        del ae_models, weights, ae_images
        torch.cuda.empty_cache()
    log(f"train graphs: {time.perf_counter() - start:.1f} s")
    return {k.split(".")[0]: v for k, v in ldm_report["graphed"]["per_replay"].items()
            if k.split(".")[0] in TRAIN_STEP}


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
    (EMA on), graphed (``training.graphs.train_step_for``: the first step
    eager, then replays): (losses, U-Net params after step 1, mu after step 1 (0.1 x
    the gradient), both copied to the host, seconds of steps 2..n, memory
    in GB: the most allocated before a step (``static``), the peak of a
    step's forward and backward (read as the optimizer starts, which it
    does in the eager first step and the capture, not in a replay) and of
    a whole step, and the graph pool the step's capture holds (``pool``;
    allocated memory leaves it out))."""
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.data.tokenizer import null_condition_ids
    from ldm_tf2_tpu_torch.training import ldm_trainer as lt
    from ldm_tf2_tpu_torch.training.graphs import train_step_for

    cond, unet, ae = models
    unet.load_state_dict(s0)
    opt = lt.make_optimizer(**config["latent_diffusion_optimizer"])
    step = train_step_for(lt.make_ldm_train_step(
        unet, cond, ae, factory.build_schedule(config), opt,
        condition_dropout_rate=0.1, null_token_ids=null_condition_ids(1, 77)[0],
        remat_unet=policy, ema_decay=0.9999, seed=83, mesh=mesh))
    state = lt.init_ldm_train_state(unet, cond, opt, ema_decay=0.9999)
    losses, seconds = [], []
    first = mu = None
    memory = dict.fromkeys(("static", "fwd_bwd", "step", "pool"), 0.0)
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
        memory["pool"] = max(memory["pool"], _graph_pool_gb())
        if i:
            seconds.append(time.perf_counter() - t0)
        else:
            first = {k: p.detach().cpu() for k, p in unet.named_parameters()}
            mu = {k[len("unet."):]: v.cpu() for k, v in state.opt_state["mu"].items()}
    return losses, first, mu, seconds, memory


def _write_jpeg_records(directory: str, n: int, seed: int, side: int | None = None) -> None:
    """``n`` Example records (a random JPEG 200-320 px a side, or ``side``
    square, a caption of 21 ids) in 4 TFRecord files, with the port's
    writers."""
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
        if side is not None:
            h = w = side
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
            f"{memory['static']:.2f} GB between steps, graph pool {memory['pool']:.2f} GB "
            f"beside them (peak allocated leaves the pool out); steps 2-3 {s_step:.4f} s/step "
            f"({', '.join(f'{x:.4f}' for x in seconds)}); launches over 3 steps "
            f"{launches}; {line}")
        del first, mu
    unet.load_state_dict(s0)
    log("remat summary (peak allocated a step / forward and backward / between steps, "
        "graph pool; s/step): "
        + "; ".join(f"{p}: {m['step']:.2f} / {m['fwd_bwd']:.2f} / {m['static']:.2f} GB, "
                    f"pool {m['pool']:.2f} GB, {s:.4f} s" for p, m, s in report))


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


# phase_loader: seeded records, batch, and the steps fed from the indexed loader
LOADER_RECORDS, LOADER_SIDE, LOADER_BATCH, LOADER_STEPS = 256, 256, 8, 2
LOADER_CODE = 2 / 255  # one code of a uint8 pixel after /127.5 - 1


def phase_loader(card: str, models) -> dict:
    """The native reader (``ldm_tf2_tpu_torch/data/native``) on the card's
    host, built from the checkout's source at first use and required
    (``native.require()``; where the host lacks libjpeg, the framing, CRC
    and Example part, and the missing decode printed): ``LOADER_RECORDS``
    seeded ``LOADER_SIDE``^2 JPEG records with captions written by the
    port's writers; the framing index, every record's ``pread`` bytes and
    every caption equal to the Python path's; one epoch of batches of the
    indexed and the streaming loader, native against Python, equal (or the
    values that differ counted, each within ``LOADER_CODE``), each timed in
    img/s; then ``LOADER_STEPS`` graphed LDM train steps at batch
    ``LOADER_BATCH`` through ``cli/run_ldm_trainer.train`` fed by the native
    indexed loader (``deterministic_data``), its decodes counted, rows 1-3's
    launches read around them."""
    import shutil
    import tempfile

    import numpy as np

    from ldm_tf2_tpu_torch import graphs as shared
    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train
    from ldm_tf2_tpu_torch.data import dataset, indexed, native
    from ldm_tf2_tpu_torch.data.example_proto import decode_example

    start = time.perf_counter()
    native.available()  # builds the library
    build_s = time.perf_counter() - start
    try:
        native.require()
        decode = "libjpeg decode"
    except RuntimeError as e:
        log(f"loader on {card}: the native reader lacks its JPEG decode on this host; "
            f"images decode in Python ({e})")
        native.require(decode=False)
        decode = "NO native decode (libjpeg missing)"
    log(f"loader: native reader built in {build_s:.1f} s ({native.library_path()}), "
        f"{decode}")
    unet = models[1]
    s0 = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    tmp = tempfile.mkdtemp(prefix="ldm_loader_")
    root = os.path.join(tmp, "records")
    out = {}
    try:
        _write_jpeg_records(root, LOADER_RECORDS, 91, side=LOADER_SIDE)
        files = dataset.list_tfrecords(root)
        index = indexed.build_index(files, native=True)
        check(np.array_equal(index, indexed.build_index(files, native=False))
              and len(index) == LOADER_RECORDS, "loader: the native framing index differs")
        for file_idx, offset, length in index:
            path = files[int(file_idx)]
            record = native.pread(path, int(offset), int(length))
            check(record == indexed._read_record(path, int(offset), int(length)),
                  f"loader: pread of {path}@{offset} differs")
            want = np.asarray(decode_example(record)["caption"], np.int64)
            got = native.example_caption(record, 77)
            check(np.array_equal(got[:len(want)], want) and not got[len(want):].any(),
                  "loader: a native caption differs")
        steps = LOADER_RECORDS // LOADER_BATCH
        kw = dict(batch_size=LOADER_BATCH, image_size=LOADER_SIDE, flip=True,
                  random_seed=5)
        loaders = {"indexed": lambda nat: indexed.create_indexed_dataset(files, native=nat,
                                                                         **kw),
                   "streaming": lambda nat: dataset.create_dataset(files, native=nat, **kw)}
        fallbacks = native.fallbacks
        for name, make in loaders.items():
            runs = {}
            for nat in (True, False):
                t0 = time.perf_counter()
                it = iter(make(nat))
                batches = [next(it) for _ in range(steps)]
                seconds = time.perf_counter() - t0
                it.close()
                runs[nat] = (batches, LOADER_RECORDS / seconds)
            diff = [np.abs(a[0] - b[0]) for a, b in zip(runs[True][0], runs[False][0])]
            differ = int(sum((d > 0).sum() for d in diff))
            worst = float(max(d.max() for d in diff))
            captions = all(np.array_equal(a[1], b[1])
                           for a, b in zip(runs[True][0], runs[False][0]))
            out[name] = dict(native_img_s=runs[True][1], python_img_s=runs[False][1],
                             values_differ=differ, max_abs=worst)
            log(f"loader on {card}: {name}, {steps} batches of {LOADER_BATCH} at "
                f"{LOADER_SIDE}^2 (one epoch, flips on, 8 decode threads): native "
                f"{runs[True][1]:.1f} img/s, Python {runs[False][1]:.1f} img/s "
                f"({runs[True][1] / runs[False][1]:.2f}x); images "
                f"{'bit-equal' if differ == 0 else f'{differ} values differ, max {worst:.3e}'}"
                f", captions equal {captions}")
            check(captions and worst <= LOADER_CODE,
                  f"loader: {name} native batches differ from Python's by {worst:.3e}")
        check(native.fallbacks == fallbacks,
              f"loader: {native.fallbacks - fallbacks} record(s) fell through to Python")
        # what the trainer's loader ran natively: each record's fetch, and
        # its decode where the host's library has one
        fetched, decoded = [], []
        real_fetch, real_decode = native.pread, dataset._make_example_native

        def fetch(*args):
            fetched.append(1)
            return real_fetch(*args)

        def decode_one(*args):
            decoded.append(1)
            return real_decode(*args)

        config = _train_config(LOADER_BATCH, LOADER_SIDE, root_path=root, ckpt_path=None,
                               num_iterations=LOADER_STEPS, ema_decay=None)
        config["ldm_training"]["params"]["flip"] = True
        config["tpu"].update(deterministic_data=True)
        config["latent_diffusion_optimizer"]["mu_dtype"] = "bfloat16"
        native.pread, dataset._make_example_native = fetch, decode_one
        try:
            before = shared.counts()
            t0 = time.perf_counter()
            _, records = train(config, device="cuda", seed=92, models=models)
            train_s = time.perf_counter() - t0
            rise = shared.rise(before, shared.counts())
        finally:
            native.pread, dataset._make_example_native = real_fetch, real_decode
        launches = {fn.__name__: n for (fn, attr), n in rise.items() if attr == "launches"}
        losses = [r["loss"] for r in records]
        rows = ("flash_attention", "fused_ffn", "flash_backward_dq", "flash_backward_dkv")
        fed = LOADER_STEPS * LOADER_BATCH
        check(len(losses) == LOADER_STEPS and all(np.isfinite(losses))
              and len(fetched) >= fed
              and (len(decoded) >= fed or not native.has_decode())
              and all(launches.get(k, 0) > 0 for k in rows),
              f"loader: the native-fed train steps: losses {losses}, {len(fetched)} native "
              f"fetches, {len(decoded)} native decodes, launches {launches}")
        out["train"] = dict(losses=losses, fetched=len(fetched), decoded=len(decoded),
                            launches=launches)
        log(f"loader on {card}: {LOADER_STEPS} graphed LDM steps at batch {LOADER_BATCH}, "
            f"{LOADER_SIDE}^2, fed by the native indexed loader ({len(fetched)} native "
            f"fetches, {len(decoded)} native decodes, {decode}, "
            f"{native.fallbacks - fallbacks} fell through): losses {losses}, launches "
            f"{launches}, {train_s:.1f} s with the capture; phase "
            f"{time.perf_counter() - start:.1f} s PASS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        unet.load_state_dict(s0)
    return out


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
    from ldm_tf2_tpu_torch.training.graphs import train_step_for

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
        step2 = train_step_for(step2)
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


# ------------------------------------------- tensor and sequence parallelism

# float32: the partials summed in rank order against the whole layer, only
# the summation order differs; bf16: the TP layer's rel L2 against the
# float32 whole layer within TP_BF16_FACTOR times the whole bf16 layer's own
TP_LAYER_TOL = 1e-5
TP_BF16_FACTOR = 2.0
# a 10-step bf16 TP or SP call's x0 against the one-process call's on the
# same weights (rel L2), and the mesh server's images against one process's
TP_SP_TOL = 5e-2
TP_SP_STEPS = 10


class _LockstepRanks:
    """The ranks of a model group run as threads on one card: each thread
    runs its shard, and ``all_reduce`` exchanges the partials, sums them in
    rank order in their dtype and hands every rank the sum.  All threads
    launch on the device's default stream, so the sum is queued after every
    partial."""

    def __init__(self, n: int):
        import threading

        self.n, self.slots, self.calls = n, [None] * n, 0
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def all_reduce(self, x):
        self.slots[self.local.rank] = x.contiguous()
        self.barrier.wait()
        total = self.slots[0].clone()
        for part in self.slots[1:]:
            total += part
        self.barrier.wait()
        if self.local.rank == 0:
            self.calls += 1
        return total

    def run(self, fns):
        """``fns[r]()`` on thread r; returns their results in rank order."""
        import threading

        out, failed = [None] * self.n, []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fns[r]()
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                failed.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failed:
            raise failed[0]
        return out


def _tp_layers():
    """(name, whole layer under the name its rules expect, its forward on
    the main path's inputs at CFG batch 4, 256^2, in a dtype)."""
    import torch
    from torch import nn

    from ldm_tf2_tpu_torch.models.transformer import EncoderLayer
    from ldm_tf2_tpu_torch.models.unet import ResidualBlock, SpatialTransformer

    def held(attr, layer, seed):
        from ldm_tf2_tpu_torch import factory

        holder = nn.Module()
        setattr(holder, attr, layer)
        factory.randomize_(holder.cuda().requires_grad_(False), seed)
        with torch.no_grad():
            for n, p in holder.named_parameters():
                if n.endswith("scale"):
                    p.add_(1.0)
        return holder

    g = torch.Generator(device="cuda").manual_seed(71)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    ctx, x0, x3, temb, tokens = (r(4, 77, 1280), r(4, 32, 32, 320), r(4, 4, 4, 1280),
                                 r(4, 1280), r(4, 77, 1280))
    return [
        ("level-0 SpatialTransformer", held("st", SpatialTransformer(320, 8, 40, 1280), 72),
         lambda m, dt: m.st(x0.to(dt), ctx.to(dt))),
        ("level-3 SpatialTransformer", held("st", SpatialTransformer(1280, 8, 160, 1280), 73),
         lambda m, dt: m.st(x3.to(dt), ctx.to(dt))),
        ("level-0 ResidualBlock", held("residual", ResidualBlock(320, 320, 1280), 74),
         lambda m, dt: m.residual(x0.to(dt), temb.to(dt))),
        ("text-encoder layer", held("layer", EncoderLayer(1280, 8, 64, 5120), 75),
         lambda m, dt: m.layer(tokens.to(dt))),
    ]


def phase_tp_layers(card: str) -> None:
    """Tensor parallelism on one card: a level-0 and a level-3 (middle
    block) SpatialTransformer, a ResidualBlock and a text-encoder layer at
    full width, at model 2 and 4.  Each rank's shard (``shard_params_tp``)
    runs as a thread, the partials are summed in rank order
    (``_LockstepRanks`` in place of ``ops.tp.all_reduce_model``), and the
    result is held against the unsharded layer: float32 within
    ``TP_LAYER_TOL`` rel L2, bf16 within ``TP_BF16_FACTOR`` times the whole
    bf16 layer's own error against float32.  Launches by path printed.  At
    model 2 the same again with the opt-in switches on (GroupNorm and fused
    conv "pallas", packed cross-attention): rows 5, 7 and 12 on the local
    shards, against the whole layer with the switches on."""
    import copy

    import torch

    from ldm_tf2_tpu_torch.ops import tp
    from ldm_tf2_tpu_torch.parallel import Mesh
    from ldm_tf2_tpu_torch.parallel.sharding import shard_params_tp

    start = time.perf_counter()
    reduce = tp.all_reduce_model
    try:
        layers = _tp_layers()
        for (name, whole, forward), opt_in in [(x, False) for x in layers] + [
                (x, True) for x in layers[:3]]:
            if opt_in:
                _set_switches("pallas", "pallas", True)
                name += ", opt-in switches on"
            else:
                _set_switches("auto", "auto", False)
            with torch.no_grad():
                ref = {dt: forward(whole, dt) for dt in (torch.float32, torch.bfloat16)}
            whole_bf16 = errors(ref[torch.bfloat16], ref[torch.float32])[1]
            for n in (2,) if opt_in else (2, 4):
                ranks = _LockstepRanks(n)
                tp.all_reduce_model = ranks.all_reduce
                shards = [shard_params_tp(copy.deepcopy(whole), Mesh({"model": n}, r, n))
                          for r in range(n)]
                for dt in (torch.float32, torch.bfloat16):
                    ranks.calls, outs = 0, []
                    runs = [lambda s=s: forward(s, dt) for s in shards]
                    with torch.no_grad():
                        took = paths_of(lambda: outs.extend(ranks.run(runs)))
                    torch.cuda.synchronize()
                    same = all(torch.equal(o, outs[0]) for o in outs)
                    _, rel = errors(outs[0], ref[torch.float32])
                    if dt == torch.float32:
                        bound, err = TP_LAYER_TOL, errors(outs[0], ref[dt])[1]
                    else:
                        bound, err = TP_BF16_FACTOR * whole_bf16, rel
                    ok = same and err < bound and bool(torch.isfinite(outs[0]).all())
                    dname = str(dt).split(".")[-1]
                    log(f"tp layers on {card}: {name} model {n} {dname}: rel L2 {err:.3e} "
                        f"(bound {bound:.3e}; whole bf16 vs float32 {whole_bf16:.3e}), "
                        f"ranks equal {same}, {ranks.calls} all-reduces, launches by path "
                        f"{took} {'PASS' if ok else 'FAIL'}")
                    check(ok, f"tensor-parallel {name} at model {n} ({dname}) differs from "
                              "the whole layer")
                del shards
    finally:
        tp.all_reduce_model = reduce
        _set_switches("auto", "auto", False)
    torch.cuda.empty_cache()
    log(f"tp layers: {time.perf_counter() - start:.1f} s")


def _tp_sp_config(mesh: dict, side: int = 32, **tpu) -> dict:
    """The north star at ``TP_SP_STEPS`` CFG DDIM steps (eta 0), batch 2,
    a ``side`` x ``side`` latent, on ``mesh``."""
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(NORTH_STAR))
    config["ldm"].update(num_ddim_steps=TP_SP_STEPS)
    config["ldm_sampling"].update(latent_shape=[2, side, side, 4],
                                  vocab_dir=os.path.join(ROOT, "bert_model"))
    config["tpu"].update(mesh=mesh, **tpu)
    return validate(config)


SERVE_MESH_REQUESTS = "\n".join(json.dumps(r) for r in (
    {"prompt": "a virus monster is playing guitar", "seed": 1, "out": "m1"},
    {"prompt": ["an oil painting of a harbour", "a red fox"], "seed": 2,
     "guidance_scale": 7.5, "out": "m2"},
    {"prompt": "a lighthouse at dusk", "n": 1, "seed": 1, "out": "m3"},
    {"prompt": "a bowl of fruit", "seed": 3, "out": "m4"},
))


def _tp_sp_models(config):
    from ldm_tf2_tpu_torch import factory

    return [factory.randomize_(build(config, device="cuda"), seed)
            for seed, build in ((31, factory.build_cond_model), (32, factory.build_unet),
                                (33, factory.build_autoencoder))]


def _eval_times(unet, shape, context, what: dict, n: int = 5) -> None:
    """One U-Net eval's wall time (median of ``n`` CUDA-event timings after
    one warm-up) and device busy time (the kernels' device time over one
    profiler window of ``n`` evals, per eval) into ``what``.  The number of
    evals is fixed, so that ranks that all-reduce inside the eval make the
    same calls (``device_ms`` takes windows until two agree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
    t = torch.full((shape[0],), 500, device="cuda")
    with torch.inference_mode():
        call = lambda: unet(x, t, context)
        wall = time_ms(call, iters=n, warmup=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    what.update(eval_ms=wall, eval_busy_ms=busy_us / 1e3 / n)


def _tp_sp_call(config, mesh, models, tokens, result: dict, key: str):
    """``apply_parallelism`` then one ``sample_txt2img`` call (this rank's
    data rows, gathered), its launches counted around it (this process's
    counters set to 0 just before, read just after), its seconds and peak
    memory, and one U-Net eval's times and all-reduces."""
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import (
        apply_parallelism, rank_rows, sample_txt2img,
    )
    from ldm_tf2_tpu_torch.ops import sequence_parallel as sp
    from ldm_tf2_tpu_torch.ops import tp
    from ldm_tf2_tpu_torch.parallel import gather_rows

    shape = tuple(config["ldm_sampling"]["latent_shape"])
    apply_parallelism(config, mesh, models, log if mesh.rank == 0 else (lambda *a: None))
    rows = mesh if mesh.distributed and shape[0] % mesh.data_size == 0 else None
    ids, b = rank_rows(tokens, shape[0], rows) if rows is not None else (tokens, shape[0])
    kwargs = dict(guidance_scale=5.0, scale_factor=config["ldm"]["scale_factor"], seed=0,
                  device="cuda", mesh=rows)
    counters = _counters()
    ulysses, exchange = [], sp.ulysses_attention
    sp.ulysses_attention = lambda *a, **k: ulysses.append(1) or exchange(*a, **k)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        start = time.perf_counter()
        images, x0 = sample_txt2img(*models, factory.build_schedule(config), ids,
                                    (b,) + shape[1:], **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = _read(counters)
    finally:
        sp.ulysses_attention = exchange
    paths = {k: dict(LAST_PATHS[k]) for k in ("flash_attention", "fused_ffn",
                                               "fused_ffn_partial")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    counted = []
    reduce = tp.all_reduce_model
    tp.all_reduce_model = lambda x: counted.append(1) or reduce(x)
    try:
        with torch.inference_mode():
            context = models[0](ids.to("cuda"))
            encode = len(counted)
            eval_times = {}
            _eval_times(models[1], (2 * b,) + shape[1:], context, eval_times)
            counted.clear()
            models[1](torch.zeros((2 * b,) + shape[1:], device="cuda", dtype=torch.bfloat16),
                      torch.full((2 * b,), 500, device="cuda"), context)
    finally:
        tp.all_reduce_model = reduce
    result[key] = dict(
        images=gather_rows(images, rows).float().cpu(), x0=gather_rows(x0, rows).float().cpu(),
        seconds=seconds, launches=launches, paths=paths, peak_gb=peak,
        ulysses_calls=len(ulysses),
        unet_weight_bytes=sum(p.numel() * p.element_size() for p in models[1].parameters()),
        all_reduces_per_eval=len(counted), all_reduces_per_encode=encode, **eval_times)


def _tp_sp_rank(rank: int, world: int, port: int, backend: str, out: str, meshes: dict):
    """One rank of ``phase_tp_sp``: the collectives' check, then the TP
    call, the SP call at 512^2 and a ``serve()`` wave, each on its mesh."""
    import io
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.parallel import create_mesh

    import datetime

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    # a collective that one rank never joins raises after 5 minutes
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=5))
    result = {"collectives": {}}
    try:
        if backend == "gloo":
            result["collectives"] = _collectives_check(world)
            bad = {k: v for k, v in result["collectives"].items() if v != "ok"}
            if bad:
                return
        tokens = torch.as_tensor(cfg_token_ids(
            load_tokenizer(os.path.join(ROOT, "bert_model")), NORTH_STAR["ldm_sampling"]
            ["text_prompt"], 2, 77))
        if "tp" in meshes:
            config = _tp_sp_config(meshes["tp"], tensor_parallel=True)
            _tp_sp_call(config, create_mesh(config["tpu"]["mesh"]), _tp_sp_models(config),
                        tokens, result, "tp")
            torch.cuda.empty_cache()
        if "sp" in meshes:
            config = _tp_sp_config(meshes["sp"], side=64, sequence_parallel=True)
            _tp_sp_call(config, create_mesh(config["tpu"]["mesh"]), _tp_sp_models(config),
                        tokens, result, "sp")
            torch.cuda.empty_cache()
        if "serve" in meshes:
            config = _tp_sp_config(meshes["serve"])
            stream = io.StringIO(SERVE_MESH_REQUESTS if rank == 0 else "")
            sink = io.StringIO()
            with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
                serve_ldm.serve(config, stream, sink, output_dir=out_dir, device="cuda",
                                models=_tp_sp_models(config))
                resps = [json.loads(line) for line in sink.getvalue().splitlines()]
                result["serve"] = dict(responses=resps, images={
                    r["out"].rsplit("/", 1)[-1]: np.load(r["out"]) for r in resps if r["ok"]})
    finally:
        if rank == 0:
            torch.save(result, out)
        dist.destroy_process_group()


def _collectives_check(world: int) -> dict:
    """Whether the process group takes CUDA tensors for every collective the
    port calls (all_reduce in float32 and bf16, all_gather, all_to_all_single,
    broadcast_object_list): "ok", or the error."""
    import torch
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_to_all_single

    rank = dist.get_rank()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tests = {
            "all_reduce": lambda: _all_reduced(dt, world, rank),
            "all_gather": lambda: _all_gathered(dt, world, rank),
            "all_to_all_single": lambda: bool(torch.equal(
                all_to_all_single(torch.empty(world, device="cuda", dtype=dt),
                                  torch.full((world,), float(rank), device="cuda", dtype=dt)),
                torch.arange(world, device="cuda", dtype=dt))),
        }
        for name, test in tests.items():
            try:
                out[f"{name} {str(dt).split('.')[-1]}"] = "ok" if test() else "wrong values"
            except Exception as e:  # noqa: BLE001 - reported and failed on
                out[f"{name} {str(dt).split('.')[-1]}"] = f"{type(e).__name__}: {e}"[:300]
    try:
        obj = [["wave"] if rank == 0 else None, rank == 0]
        dist.broadcast_object_list(obj, src=0)
        out["broadcast_object_list"] = "ok" if obj == [["wave"], True] else "wrong values"
    except Exception as e:  # noqa: BLE001
        out["broadcast_object_list"] = f"{type(e).__name__}: {e}"[:300]
    return out


def _all_reduced(dt, world, rank) -> bool:
    import torch
    import torch.distributed as dist

    x = torch.full((8,), float(rank + 1), device="cuda", dtype=dt)
    dist.all_reduce(x)
    return bool((x == world * (world + 1) / 2).all())


def _all_gathered(dt, world, rank) -> bool:
    import torch
    import torch.distributed as dist

    parts = [torch.empty(4, device="cuda", dtype=dt) for _ in range(world)]
    dist.all_gather(parts, torch.full((4,), float(rank), device="cuda", dtype=dt))
    return all(bool((p == r).all()) for r, p in enumerate(parts))


def _tp_sp_reference(key: str, config, tokens) -> dict:
    """The one-process call of ``key`` on the same weights."""
    import io
    import tempfile

    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img

    models = _tp_sp_models(config)
    if key == "serve":
        sink = io.StringIO()
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            serve_ldm.serve(config, io.StringIO(SERVE_MESH_REQUESTS), sink,
                            output_dir=out_dir, device="cuda", models=models)
            resps = [json.loads(line) for line in sink.getvalue().splitlines()]
            return dict(responses=resps, images={r["out"].rsplit("/", 1)[-1]: np.load(r["out"])
                                                 for r in resps if r["ok"]})
    shape = tuple(config["ldm_sampling"]["latent_shape"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    images, x0 = sample_txt2img(*models, factory.build_schedule(config), tokens, shape,
                                guidance_scale=5.0, scale_factor=config["ldm"]["scale_factor"],
                                seed=0, device="cuda")
    torch.cuda.synchronize()
    out = dict(images=images.float().cpu(), x0=x0.float().cpu(),
               seconds=time.perf_counter() - start,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               unet_weight_bytes=sum(p.numel() * p.element_size()
                                     for p in models[1].parameters()))
    with torch.inference_mode():
        _eval_times(models[1], (2 * shape[0],) + shape[1:], models[0](tokens.cuda()), out)
    return out


def phase_tp_sp(card: str) -> dict:
    """Tensor parallelism, sequence parallelism and the server on a mesh,
    in spawned ranks: two gloo ranks on this one card (NCCL refuses two
    ranks on one device), each calling ``dist.init_process_group`` before
    the port, which then leaves the group alone; on a machine with two or
    more cards the same calls under NCCL, one rank a card, and with four,
    tensor parallelism on ``{"data": 2, "model": 2}``.  The calls: a
    full-width TP sampler call (``TP_SP_STEPS`` CFG DDIM steps, batch 2,
    256^2, ``{"data": 1, "model": 2}``), an SP call at 512^2 (latent
    [2, 64, 64, 4]: level 0's 4096 tokens and 8 heads through the
    exchange), a ``serve()`` wave of four requests on ``{"data": 2}``; each
    against the one-process call on the same weights (``TP_SP_TOL``), with
    its launches (the partial FFN's among them), all-reduces per U-Net eval
    and text encode, U-Net weight bytes, peak memory and eval times.
    Returns the gloo TP call's result on rank 0 (its launches and launches
    by path)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer

    start = time.perf_counter()
    tokens = torch.as_tensor(cfg_token_ids(load_tokenizer(os.path.join(ROOT, "bert_model")),
                                           NORTH_STAR["ldm_sampling"]["text_prompt"], 2, 77))
    two = {"tp": {"data": 1, "model": 2}, "sp": {"data": 1, "model": 2}, "serve": {"data": 2}}
    runs = [("gloo", 2, two)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", 2, two))
    if torch.cuda.device_count() >= 4:
        runs.append(("nccl", 4, {"tp": {"data": 2, "model": 2}, "sp": {"data": 2, "model": 2}}))
    refs = {"tp": _tp_sp_reference("tp", _tp_sp_config({"data": -1}), tokens),
            "sp": _tp_sp_reference("sp", _tp_sp_config({"data": -1}, side=64), tokens),
            "serve": _tp_sp_reference("serve", _tp_sp_config({"data": -1}), tokens)}
    torch.cuda.empty_cache()
    for what in ("tp", "sp"):
        r = refs[what]
        log(f"tp/sp one process on {card}: {what}: {r['seconds']:.3f} s, U-Net eval "
            f"{r['eval_ms']:.3f} ms wall, {r['eval_busy_ms']:.3f} ms busy, U-Net weights "
            f"{r['unet_weight_bytes'] / 1e9:.3f} GB, peak {r['peak_gb']:.2f} GB")
    gloo_tp = None
    for backend, world, meshes in runs:
        out = os.path.join(tempfile.mkdtemp(prefix="ldm_tp_sp_"), "rank0.pt")
        t0 = time.perf_counter()
        mp.start_processes(_tp_sp_rank, args=(world, _free_port(), backend, out, meshes),
                           nprocs=world, join=True, start_method="spawn")
        got = torch.load(out, weights_only=False)
        bad = {k: v for k, v in got["collectives"].items() if v != "ok"}
        log(f"tp/sp {backend} x{world}: collectives on CUDA tensors {got['collectives']}")
        check(not bad, f"{backend} refuses CUDA tensors for: {bad}")
        for what in ("tp", "sp"):
            if what not in meshes:
                continue
            r, ref = got[what], refs[what]
            x0_abs, x0_rel = errors(r["x0"], ref["x0"])
            im_abs, im_rel = errors(r["images"], ref["images"])
            # SP: level 0's 5 self-attentions an eval through the exchange
            want = {"flash_attention": r["launches"]["flash_attention"] > 0,
                    "fused_ffn" if what == "sp" else "fused_ffn_partial":
                        r["launches"]["fused_ffn" if what == "sp" else "fused_ffn_partial"] > 0,
                    "ulysses": r["ulysses_calls"] == (5 * TP_SP_STEPS if what == "sp" else 0)}
            fma = {k: p.get("fma", 0) for k, p in r["paths"].items() if p.get("fma", 0)}
            ok = (x0_rel < TP_SP_TOL and bool(torch.isfinite(r["images"]).all())
                  and all(want.values()) and not fma)
            log(f"tp/sp {backend} x{world} on {card}: {what} on {meshes[what]}: x0 max abs "
                f"{x0_abs:.3e} rel L2 {x0_rel:.3e} (bound {TP_SP_TOL:g}), images max abs "
                f"{im_abs:.3e} rel L2 {im_rel:.3e}; {r['seconds']:.3f} s (one process "
                f"{ref['seconds']:.3f}); U-Net eval {r['eval_ms']:.3f} ms wall, "
                f"{r['eval_busy_ms']:.3f} ms busy per rank (one process {ref['eval_ms']:.3f}, "
                f"{ref['eval_busy_ms']:.3f}); all-reduces per eval {r['all_reduces_per_eval']}, "
                f"per text encode {r['all_reduces_per_encode']}; U-Net weights per rank "
                f"{r['unet_weight_bytes'] / 1e9:.3f} GB (one process "
                f"{ref['unet_weight_bytes'] / 1e9:.3f}); peak {r['peak_gb']:.2f} GB (one "
                f"process {ref['peak_gb']:.2f}); Ulysses calls {r['ulysses_calls']}; "
                f"launches {r['launches']}; by path "
                f"{r['paths']} {'PASS' if ok else 'FAIL'}")
            check(ok, f"{what} over {backend} x{world} differs from one process, or missed "
                      f"its kernels: {want}, FMA {fma}")
            if what == "tp" and backend == "gloo":
                gloo_tp = r
        if "serve" in meshes:
            r, ref = got["serve"], refs["serve"]
            ok = [x["ok"] for x in r["responses"]] == [x["ok"] for x in ref["responses"]]
            worst = 0.0
            for name, image in ref["images"].items():
                a = torch.as_tensor(r["images"][name]).float()
                worst = max(worst, errors(a, torch.as_tensor(image).float())[1])
            ok = ok and worst < TP_SP_TOL
            waves = [x["latency_s"] for x in r["responses"]][:1]
            ref_waves = [x["latency_s"] for x in ref["responses"]][:1]
            log(f"tp/sp {backend} x{world} on {card}: serve on {meshes['serve']}: "
                f"{len(r['responses'])} responses, images rel L2 at most {worst:.3e} (bound "
                f"{TP_SP_TOL:g}); one wave of 4 requests (4 calls of batch 2) "
                f"{waves} s, one process {ref_waves} s {'PASS' if ok else 'FAIL'}")
            check(ok, f"the server on {meshes['serve']} over {backend} differs from one process")
        log(f"tp/sp {backend} x{world}: {time.perf_counter() - t0:.1f} s")
    log(f"tp/sp: {time.perf_counter() - start:.1f} s")
    return gloo_tp


# Tensor-parallel training: the LDM step at the full-width config (256^2,
# text encoder frozen as the config has it, U-Net dropout 0.1, a clip of
# TP_TRAIN_CLIP) at model 2, global batch TP_TRAIN_BATCH, against one
# process at the same batch, cuDNN deterministic in both.  As in
# phase_resume, a bf16 first moment and no EMA keep the checkpoint at 8.7 GB:
# the machine takes 45 GiB of disk writes a run (tests/test_torch_tp_train.py
# holds the EMA's gather and reshard)
TP_TRAIN_BATCH = 2
TP_TRAIN_SIZE = 256
TP_TRAIN_STEPS = 3
TP_TRAIN_CLIP = 1.0
# Step 1's gradients per group (rel L2 against one process's float32 step):
# float32 (TF32 off) within DP_TOL, as the two-rank data-parallel phase;
# bf16 within TP_BF16_FACTOR times the one-process bf16 step's own distance
# from the float32 step (the partials are rounded to bf16 before they are
# summed)
TP_TRAIN_DTYPES = ("float32", "bfloat16")
# What one TP step launches at model 2: the calls of one process's step
# (TRAIN_STEP) on 4 local heads, every FFN in the partial mode
TP_TRAIN_STEP = {"flash_attention": 17, "flash_backward_dq": 16,
                 "flash_backward_dkv": 16, "fused_ffn": 16, "fused_ffn_partial": 16}


def _tp_train_config(dtype: str) -> dict:
    config = _train_config(TP_TRAIN_BATCH, TP_TRAIN_SIZE)
    config["latent_diffusion_optimizer"].update(clip_grad_norm=TP_TRAIN_CLIP,
                                                mu_dtype="bfloat16")
    if dtype == "float32":
        config["tpu"].update(compute_dtype="float32", frozen_weights_dtype="float32")
    return config


def _tp_train_steps(dtype: str, mesh, ckpt_dir: str | None = None) -> dict:
    """``TP_TRAIN_STEPS`` LDM steps of the seeded north-star models in
    ``dtype`` (one process without ``mesh``; else the text encoder and the
    U-Net sharded by ``shard_params_tp`` and this rank's share of the
    step): the losses, step 1's gradients (a rank's blocks), the U-Net's
    sharded leaves and its parameters, seconds of steps 2.., peak memory,
    the launches of step 2; with ``ckpt_dir``, the state saved through
    ``CheckpointManager`` and restored, each leaf compared bit for bit."""
    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
    from ldm_tf2_tpu_torch.data.tokenizer import null_condition_ids
    from ldm_tf2_tpu_torch.parallel import shard_batch
    from ldm_tf2_tpu_torch.parallel.sharding import shard_params_tp, sharded_leaves
    from ldm_tf2_tpu_torch.training import ldm_trainer as lt

    config = _tp_train_config(dtype)
    torch.cuda.reset_peak_memory_stats()
    cond, unet, ae = _train_models(config, "cuda")
    if mesh is not None:
        shard_params_tp(cond, mesh)
        shard_params_tp(unet, mesh)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(97)
    size = TP_TRAIN_SIZE
    images = torch.as_tensor(rng.uniform(-1, 1, (TP_TRAIN_BATCH, size, size, 3)),
                             dtype=torch.float32 if dtype == "float32" else torch.bfloat16,
                             device="cuda")
    ids = torch.as_tensor(rng.integers(1000, 30000, (TP_TRAIN_BATCH, 77)), device="cuda")
    images, ids = shard_batch(images, mesh), shard_batch(ids, mesh)
    opt = lt.make_optimizer(**config["latent_diffusion_optimizer"])
    grads, apply = {}, opt.step_

    def step_(params, g, state, *args):
        moved = apply(params, g, state, *args)
        if not grads:  # step 1's, after the data mean (taken in place)
            grads.update({k: v.detach().clone() for k, v in g.items()})
        return moved

    opt.step_ = step_
    step = lt.make_ldm_train_step(
        unet, cond, ae, factory.build_schedule(config), opt,
        condition_dropout_rate=0.1, null_token_ids=null_condition_ids(1, 77)[0],
        seed=98, mesh=mesh)
    state = lt.init_ldm_train_state(unet, cond, opt)
    counters = _counters()
    losses, seconds, launches = [], [], {}
    for i in range(TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            _reset(counters)
        t0 = time.perf_counter()
        state, m = step(state, images, ids)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        if i == 1:
            launches = {k: v for k, v in _read(counters).items() if k in TP_TRAIN_STEP}
            launches["paths"] = {k: dict(LAST_PATHS[k]) for k in (
                "flash_attention", "flash_backward_dq", "flash_backward_dkv",
                "fused_ffn_partial")}
    out = dict(losses=losses, grads=grads, seconds=seconds, launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               shards=sharded_leaves({"unet": unet}),
               params={f"unet.{k}": p.detach() for k, p in unet.named_parameters()},
               unet_bytes=sum(p.numel() * p.element_size() for p in unet.parameters()))
    if ckpt_dir is not None:
        saved = lt.checkpoint_state(state, unet)
        manager = CheckpointManager(ckpt_dir, mesh=mesh, shards=out["shards"])
        t0 = time.perf_counter()
        path = manager.save(state.step, saved)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_no, restored = manager.restore_latest(map_location="cpu")
        restore_s = time.perf_counter() - t0
        same = step_no == state.step
        same &= all(torch.equal(restored["unet"][k].cuda(), v) for k, v in saved["unet"].items())
        for part in ("mu", "nu"):
            same &= all(torch.equal(restored["opt_state"][part][k].cuda(), v)
                        for k, v in saved["opt_state"][part].items())
        whole = True  # the file's leaves have one process's shapes
        if mesh.rank == 0:
            n = mesh.size("model")
            file = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
            for k, v in saved["unet"].items():
                shape = list(v.shape)
                shard = out["shards"].get(f"unet.{k}")
                if shard is not None:
                    shape[shard.dim] *= n
                whole &= (list(file["unet"][k].shape) == shape
                          == list(file["opt_state"]["mu"][f"unet.{k}"].shape))
            del file
        out["ckpt"] = dict(same=bool(same), whole=bool(whole), save_s=save_s,
                           restore_s=restore_s, bytes=os.path.getsize(path))
    return out


def _tp_train_compare(run: dict, refs: dict | None, dtype: str, mesh) -> dict:
    """On every rank of the model group, step 1's gradients gathered: on
    rank 0 (``refs``: one process's step-1 gradients by dtype, on the host)
    their rel L2 per ``_grad_group`` against one process's float32 (and, for
    bf16, bf16) gradients and their global norm; everywhere, how many
    replicated leaves' gradients and values are bit-equal on the peers."""
    import torch
    import torch.distributed as dist

    group, n = mesh.group("model"), mesh.size("model")
    sums = {d: {} for d in (("float32",) if dtype == "float32" else TP_TRAIN_DTYPES)}
    norm_sq, same, replicated = 0.0, 0, 0

    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    for k, g in run["grads"].items():
        parts, shard = gathered(g), run["shards"].get(k)
        if shard is None:
            replicated += 1
            values = gathered(run["params"][k])
            same += all(torch.equal(p, parts[0]) for p in parts[1:]) and all(
                torch.equal(v, values[0]) for v in values[1:])
        whole = (torch.cat(parts, dim=shard.dim) if shard is not None else parts[0]).float()
        norm_sq += float(whole.square().sum())
        if refs is None:
            continue
        for d, acc in sums.items():
            w = refs[d][k].to(whole.device)
            pair = acc.setdefault(_grad_group(k), [0.0, 0.0])
            pair[0] += float((whole - w).square().sum())
            pair[1] += float(w.square().sum())
    rel = {d: {g: (a / max(b, 1e-30)) ** 0.5 for g, (a, b) in acc.items()}
           for d, acc in sums.items()}
    return dict(rel=rel, norm=norm_sq ** 0.5, same=same, replicated=replicated)


def _tp_train_rank(rank: int, world: int, port: int, backend: str, out_dir: str,
                   shape: dict):
    """One rank of ``phase_tp_train``: rank 0 first takes one process's
    steps in each dtype (the others wait), then every rank the TP steps on
    the mesh ``shape`` in each dtype, their gradients compared on rank 0,
    and a checkpoint round trip after the bf16 ones."""
    import datetime

    import torch
    import torch.distributed as dist

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.ops import tp
    from ldm_tf2_tpu_torch.parallel import barrier, create_mesh

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    factory.set_float32_precision()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=5))
    result: dict = {"ref": {}, "tp": {}}
    try:
        mesh = create_mesh(shape)
        refs = None
        with _DeterministicCudnn():
            if rank == 0:
                refs = {}
                for dtype in TP_TRAIN_DTYPES:
                    ref = _tp_train_steps(dtype, None)
                    refs[dtype] = {k: v.float().cpu() for k, v in ref["grads"].items()}
                    norm = float(torch.stack([g.norm() for g in refs[dtype].values()]).norm())
                    result["ref"][dtype] = dict(
                        losses=ref["losses"], seconds=ref["seconds"], peak_gb=ref["peak_gb"],
                        unet_bytes=ref["unet_bytes"], norm=norm)
                    del ref
                    torch.cuda.empty_cache()
                result["own"] = _group_rel(refs["bfloat16"], refs["float32"])
            barrier(mesh)
            tp.enable_tensor_parallel(mesh)
            for dtype in TP_TRAIN_DTYPES:
                ckpt = os.path.join(out_dir, "ckpt") if dtype == "bfloat16" else None
                run = _tp_train_steps(dtype, mesh, ckpt)
                cmp = _tp_train_compare(run, refs, dtype, mesh)
                mine = dict(losses=run["losses"], seconds=run["seconds"],
                            peak_gb=run["peak_gb"], ckpt=run.get("ckpt"))
                ranks = [None] * world
                dist.all_gather_object(ranks, mine)
                result["tp"][dtype] = dict(cmp, ranks=ranks, launches=run["launches"],
                                           unet_bytes=run["unet_bytes"])
                del run
                torch.cuda.empty_cache()
    finally:
        tp.enable_tensor_parallel(None)
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(result, f)
        dist.destroy_process_group()


def phase_tp_train(card: str) -> dict:
    """The LDM train step under tensor parallelism at full width: two gloo
    ranks on this one card (NCCL ranks too, one a card, where the machine
    has two; with four, also ``{"data": 2, "model": 2}``), each calling
    ``dist.init_process_group`` before the port, on ``{"model": 2}``,
    against one process at the same global batch (rank 0's, before the TP
    steps), in float32 (TF32 off) and in bf16 over float32
    masters: step 1's gradient per group (bounds at ``TP_TRAIN_DTYPES``),
    the global norm the clip reads, the losses, replicated leaves bit-equal
    on the peers, the launches of one step (``TP_TRAIN_STEP``), s/step and
    peak memory per rank, and a checkpoint saved under TP (whole leaves)
    and restored on every rank bit for bit.  Returns the gloo run's
    launches of one step."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    start = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = [("gloo", {"model": 2})]
    if cards >= 2:
        runs.append(("nccl", {"model": 2}))
    if cards >= 4:
        runs.append(("nccl", {"data": 2, "model": 2}))
    gloo = None
    for backend, shape in runs:
        world = shape.get("data", 1) * shape["model"]
        out_dir = tempfile.mkdtemp(prefix="ldm_tp_train_")
        try:
            t0 = time.perf_counter()
            mp.start_processes(_tp_train_rank,
                               args=(world, _free_port(), backend, out_dir, shape),
                               nprocs=world, join=True, start_method="spawn")
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "result.json")) as f:
                r = json.load(f)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        ok = True
        for dtype in TP_TRAIN_DTYPES:
            ref, got = r["ref"][dtype], r["tp"][dtype]
            log(f"tp train one process on {card} (rank 0, {backend}): {dtype}, batch "
                f"{TP_TRAIN_BATCH}, {TP_TRAIN_SIZE}^2: losses {ref['losses']}, "
                f"{statistics.median(ref['seconds']):.4f} s/step, peak {ref['peak_gb']:.2f} GB, "
                f"U-Net weights {ref['unet_bytes'] / 1e9:.3f} GB, global norm {ref['norm']:.6g}")
            rel = got["rel"]["float32"]
            bounds = {g: DP_TOL if dtype == "float32" else TP_BF16_FACTOR * r["own"][g]
                      for g in rel}
            loss_rel = max(abs(a - b) / abs(b) for x in got["ranks"]
                           for a, b in zip(x["losses"], ref["losses"]))
            launches = {k: v for k, v in got["launches"].items() if k != "paths"}
            step_ok = (all(rel[g] < bounds[g] for g in rel) and loss_rel < DP_TOL
                       and got["same"] == got["replicated"] and launches == TP_TRAIN_STEP
                       and all(x["ckpt"] is None or (x["ckpt"]["same"] and x["ckpt"]["whole"])
                               for x in got["ranks"]))
            ok &= step_ok
            log(f"tp train {backend} x{world} on {card}: {shape}, {dtype}: step 1 gradient "
                "rel L2 per "
                "group against one process's float32 step "
                + ", ".join(f"{g} {v:.3e} (bound {bounds[g]:.3e})" for g, v in rel.items())
                + ("" if dtype == "float32" else "; against one process's bf16 step "
                   + ", ".join(f"{g} {v:.3e}" for g, v in got["rel"]["bfloat16"].items()))
                + f"; global norm {got['norm']:.6g} (one process {ref['norm']:.6g}, clip "
                f"{TP_TRAIN_CLIP:g}); losses {[x['losses'] for x in got['ranks']]} (rel "
                f"{loss_rel:.2e}, bound {DP_TOL:g}); replicated leaves bit-equal on the peers "
                f"{got['same']} of {got['replicated']}; launches of step 2 {launches} (want "
                f"{TP_TRAIN_STEP}), by path {got['launches']['paths']}; s/step per rank "
                + ", ".join(f"{statistics.median(x['seconds']):.4f}" for x in got["ranks"])
                + f" (one process {statistics.median(ref['seconds']):.4f}); peak per rank "
                + ", ".join(f"{x['peak_gb']:.2f}" for x in got["ranks"])
                + f" GB (one process {ref['peak_gb']:.2f}); U-Net weights per rank "
                f"{got['unet_bytes'] / 1e9:.3f} GB (one process {ref['unet_bytes'] / 1e9:.3f}) "
                f"{'PASS' if step_ok else 'FAIL'}")
            ck = [x["ckpt"] for x in got["ranks"] if x["ckpt"] is not None]
            if ck:
                log(f"tp train {backend} x{world}: checkpoint at step {TP_TRAIN_STEPS} (the "
                    f"sharded U-Net leaves and their moments gathered): "
                    f"{ck[0]['bytes'] / 1e9:.3f} GB, whole leaves {ck[0]['whole']}, saved in "
                    f"{ck[0]['save_s']:.1f} s, restored on each rank in "
                    + ", ".join(f"{c['restore_s']:.1f}" for c in ck)
                    + f" s, bit-equal on every rank {all(c['same'] for c in ck)}")
            if backend == "gloo" and dtype == "bfloat16":
                gloo = got["launches"]
        log(f"tp train {backend} x{world}: {wall:.1f} s")
        check(ok, f"the TP train step over {backend} x{world} on {shape} differs from one "
                  "process")
    log(f"tp train: {time.perf_counter() - start:.1f} s")
    return gloo

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
                    bare_ms: float | None = None) -> dict | None:
    """Device time by kernel group per unit over a profiled window of ``n``
    units, and the device's idle share of the window's wall time (and of
    ``bare_ms``, the same work timed without the profiler, when given).
    Returns the device busy time, the launches and, among them, the copies
    and memsets per unit (None when the window recorded no device time)."""
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
    launches = sum(c for _, c in kernels.values()) / n
    copies = sum(c for name, (_, c) in kernels.items()
                 if "memcpy" in name.lower() or "memset" in name.lower()) / n
    result = {"busy_ms": busy / n, "launches": launches, "copies": copies}
    parts = ", ".join(f"{k} {v / n:.2f} ms ({v / busy:.1%})"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    bare = "" if bare_ms is None else (
        f"{bare_ms / n:.2f} ms wall per unit without the profiler, ")
    idle = "" if bare_ms is None else f"{1 - busy / bare_ms:.1%} of the unprofiled wall, "
    log(f"profile: {what}, {n} units: {bare}{wall_ms / n:.2f} ms with it; device busy "
        f"{busy / n:.2f} ms in {launches:.0f} kernel launches, idle share {idle}"
        f"{1 - busy / wall_ms:.1%} profiled; by group: {parts}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("profile: top kernels per unit: " + "; ".join(
        f"{name[:60]} {ms / n:.3f} ms x{c // n}" for name, (ms, c) in top))
    return result


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


# The phases a run with arguments can take alone (``python3 chip_smoke.py
# serve_program``), each on the north star's seeded models; the run with no
# arguments drives each of them too
ALONE = {"encode_decode": lambda card, models: phase_encode_decode(card, models,
                                                                   _program_ids()),
         "serve": phase_serve, "serve_program": phase_serve_program,
         "loader": lambda card, _: phase_loader(card, _train_models(
             _train_config(LOADER_BATCH, LOADER_SIDE), "cuda"))}


def _phase(fn, *args):
    """``fn(*args)``, a phase of the run, with the seconds it took logged,
    so that a run shows where its time limit goes."""
    start = time.perf_counter()
    try:
        return fn(*args)
    finally:
        log(f"{fn.__name__} took {time.perf_counter() - start:.1f} s")


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false")
        return 1
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.ops import _build

    unknown = [a for a in argv if a not in ALONE]
    if unknown:
        log(f"FAIL: unknown phase(s) {unknown}; phases run alone: {sorted(ALONE)}")
        return 2
    factory.set_float32_precision()
    seconds = _build.build(SOURCES)
    log("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    if argv:  # the named phases alone, on the north star's models
        from ldm_tf2_tpu_torch.configs.loader import validate

        models = _north_star_models(validate(json.loads(json.dumps(NORTH_STAR))))
        for name in argv:
            _phase(ALONE[name], card, models)
        print(card, flush=True)
        return 0

    results = _phase(phase_kernels)
    _phase(phase_tp_layers, card)
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn_int8

    ffn8_checked = fused_ffn_int8.launches  # the kernels phase's own launches
    ffn8_paths = dict(fused_ffn_int8.launches_by_path)
    _phase(phase_unet)
    _phase(phase_grad)
    launches, run = _phase(phase_main_path, card)
    by_path = {k: dict(LAST_PATHS[k]) for k in ("flash_attention", "fused_ffn")}
    # the opt-in kernels report their launches in the opt-in main path (the
    # stats kernel in its GroupNorm "stats" run), the serving path's in the
    # serve run, the backward kernels theirs in the LDM train run (5 steps)
    opt_in, stats, opt_paths = _phase(phase_opt_in, card, run)
    by_path.update(opt_paths)
    launches.update({k: opt_in[k] for k in ("group_norm_fused", "gn_silu_conv3x3_fused",
                                            "cross_attention")})
    launches["group_stats"] = stats["group_stats"]
    _phase(phase_samplers, card, run)
    _phase(phase_deepcache_img2img, card, run)
    convert_launches = _phase(phase_convert_export_eval, card)
    serve = _phase(phase_serve, card, run["models"])
    by_path.update({k: dict(LAST_PATHS[k]) for k in ("flash_attention_pv_int8", "s8_conv3x3")})
    by_path["gn_silu_quant"] = dict(LAST_MODES["gn_silu_quant"])
    launches.update({k: serve[k] for k in ("gn_silu_quant", "s8_conv3x3",
                                           "flash_attention_pv_int8")})
    _phase(phase_graphs, card, run)
    _phase(phase_serve_program, card, run["models"])
    del run
    torch.cuda.empty_cache()
    # row 2's partial mode reports its launches in the TP sampler call
    tp_call = _phase(phase_tp_sp, card)
    launches["fused_ffn_partial"] = tp_call["launches"]["fused_ffn_partial"]
    by_path["fused_ffn_partial"] = tp_call["paths"]["fused_ffn_partial"]
    train_launches, train_models = _phase(phase_train, card)
    train_graph = _phase(phase_train_graphs, card, train_models)
    by_path.update({k: dict(LAST_PATHS[k]) for k in ("flash_backward_dq", "flash_backward_dkv")})
    _phase(phase_remat, card, train_models)
    _phase(phase_resume, card, train_models)
    _phase(phase_loader, card, train_models)
    _phase(phase_data_parallel, card, train_models)
    del train_models
    torch.cuda.empty_cache()
    tp_train = _phase(phase_tp_train, card)
    launches.update({k: train_launches[k] for k in ("flash_backward_dq",
                                                    "flash_backward_dkv")})
    _phase(phase_ae_grad)
    _phase(phase_ae_train, card)
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
                "int8_chain": "ldm_tf2_tpu/ops/quant_conv.py:411",
                "fused_ffn_partial": "ldm_tf2_tpu/ops/fused_ffn.py:132"}
    source = {"flash_backward_dq": "flash_attention_bwd",
              "flash_backward_dkv": "flash_attention_bwd",
              "group_norm_fused": "group_norm", "group_stats": "group_norm",
              "gn_silu_conv3x3_fused": "gn_silu_conv3x3",
              "gn_silu_quant_stream": "gn_silu_quant",
              "int8_chain": "s8_conv3x3", "fused_ffn_partial": "fused_ffn"}
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
        if name in train_graph:  # a replayed LDM step's graph (rows 1-3), its nodes
            kernels[-1]["train_graph_launches"] = train_graph[name]
        if name in tp_train:  # one LDM step at model 2 (rows 1-3 on local heads)
            kernels[-1]["tp_train_step_launches"] = tp_train[name]
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
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
