"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (every phase)
    python3 chip_smoke.py flux     (the build, the scene and the FLUX phase)

Builds the kernels from the checkout (gaussianip_tpu_torch/csrc/: K1 and
K2, the compositor forward and backward with the per-gaussian gradient
reduction fused in, in composite.cu; K3, the 3x3 conv, in conv3x3.cu;
K4, the VAE's GroupNorm with the SiLU fused in, in groupnorm.cu; K5,
the VAE's single-head attention, in vae_attention.cu), builds the
full-size scene and drives three guided stage-1 steps on the FLUX.1-dev
stack at its published widths (`flux_phase`: the parameters' bytes by
dtype, the hand-written kernels' launches, the spans' device ms, the
peak memory; `python3 chip_smoke.py flux` stops there), holds K1/K2
against their plain PyTorch versions at the stage-1 shapes (4 cameras,
512x512, capacity 524288, d_max=16) and times them, prints the tiles'
segment lengths, checks the tiled
renderer against the dense reference compositor, and drives stage-1
training with stub guidance at the recipe's sizes (configs/exp.yaml:
pts_num 100000, capacity 524288) with one densify and one prune at full
size. Then it builds the recipe's guidance stack at full SD1.5 width with
seeded random weights (system/pipeline.py:build_random_sd15_guidance),
holds K3 against its plain version at every distinct conv shape of the
guided step (batch 12, bf16) through the variant its gate names (the
Hopper wgmma + TMA one at every SD1.5 shape) and times it beside the
general variant and F.conv2d, holds K4 against its plain version at
every GroupNorm shape of the stage-1 encode (forward and backward) and of
a refine chunk's encode and decode (forward) and times it beside its bound
and F.group_norm + F.silu, holds K5 against its plain version at the
VAE's attention shapes (the SDXL and SD1.5 encodes forward and backward,
a refine chunk forward, tiny ragged ones; bf16 and float32) and times it
beside its bound and SDPA, and drives stage-1 training with the real
AHDS / ANPG guidance (K4's launches counted: 22 GroupNorms a step; K5's:
one attention forward and backward a step), its ControlNet + UNet call
replayed from a CUDA graph (guidance/graph.py) and held against the eager
call on two input sets (check_denoise_graph); the
tiny test stack on the card runs the general variant. Then, from the stub-trained, densified and pruned state, the rest
of the avatar path: the .ply handoff and the 32 refine views at 1024^2,
K3 against its plain version at every conv shape of a refine denoise call
(128^2 latents, CFG batch 8), the largest attention on a fused backend,
the tiny stack's refine on the card against the CPU, the VCR refinement
at 1024^2 (stage 2), K1/K2 against their plain versions at 1024^2 x 4,
stage-3 steps with a random-weight LPIPS at VGG16 width across the
densify, and the turntable. Then the final avatar's animation: the
animation command line (gaussianip_tpu_torch/animation.py) in-process on
its .ply and a seeded random motion, 90 frames at 1024^2 (K1 once a
frame), K1/K2 against their plain versions on its last re-posed frame,
the closest-point bind at the SMPL-X sizes (10,475 vertices, 20,908
faces) against a dense evaluation, and animation-space refine steps (LBS
deformation of 100000 canonical points, capacity 524288, 4 views at
512^2) on the SD1.5-width guidance. Then the side systems on the final
avatar: photo reconstruction (system/photo_recon.py) of a NeRF-synthetic-
layout scene of it (100 train and 20 test frames at 512^2, written by the
port) with PhotoReconConfig()'s defaults cut to 1,001 iterations and 5
steps at SH degree 3, the test views' PSNR / SSIM / LPIPS before and after
(up by 3 dB at least), K1/K2 against their plain versions on the trained
state at 1 x 512^2; `launch --export` of its .ply to a textured
OBJ/MTL/PNG at configs/exp.yaml's exporter settings; and the live viewer
on port 0, its PNG equal to the port's render. Last, the port's command line
(gaussianip_tpu_torch/launch.py) with --stub-guidance at the recipe's
sizes: stage 1 with validation, a checkpoint, a densify and a prune, its
--resume, stage 2, and stage 3 in a child process that runs the launch
module as `python -m` does, each stage's run files and kernel launches
checked, and K1/K2 (on the stub-trained state) and the tiny stack's refine
held against their plain versions at the command line's shapes. Then the
real-weights path (cli:real): a released-layout checkpoint set written at
the published widths from seeded random modules into a temporary
directory (system/standin.py), every loaded tensor held against its
source and the loaded stack's forward against the source stack's, the
command line without --stub-guidance on that set (stage 1, stage 2 in
full, stage 3 and the turntable, with each stage's launches, LPIPS loaded
and the face-identity branch recorded) and eval_avatar. Then data
parallel (dp): two gloo ranks on the card through parallel.spawn, each
part held against the single process run in rank 0 on the same inputs
(f32 stub-guided stage-1 steps with the batch's depth max in rank 1's
views, guided stage-1 steps with a densify at 4 x 512^2, stage-3 steps at
4 x 1024^2, the refine at 1024^2), the ranks' states checked equal and every
kernel's launches counted per rank, then one stage-1 step in a
world-size-1 NCCL group. The last three tools, each run as its user runs
it, in a child process: `python -m gaussianip_tpu_torch.render_ply` on
the final avatar's .ply at 1024^2 (render_ply, after the turntable), its
PNG equal to the in-process render's with one K1 launch; `python -m
gaussianip_tpu_torch.weight_parity compare` on cli:real's set against a
float32 CPU recording of its source modules, passing it and failing a
planted fault in a copy of the UNet file (weight_parity, inside
cli:real); and, last, `python -m gaussianip_tpu_torch.bench_pipeline`
with stage 3 cut to 110 of 800 steps (bench), its line printed with every
key finite and each stage's launches counted. Prints one line per phase, a
`kernels` JSON line, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero; there is
no CPU path.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from gaussianip_tpu_torch.guidance.graph import USE as DENOISE_GRAPH_USE
from gaussianip_tpu_torch.kernels import count_launches

N_STEPS = 25
WARMUP_STEPS = 5
N_GUIDED = 6
GUIDED_WARMUP = 2
PTS_NUM = 100_000
CAPACITY = 524_288
RES = 512
BATCH = 4
D_MAX = 16
SEED = 42
# H100 SXM peaks (data sheet): f32 outside the tensor cores, dense bf16 on
# the tensor cores, HBM3 rate
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# stride-1 Conv3x3 calls per guided step: 47 in the UNet (22 ResnetBlocks
# x 2 + 3 Upsample), 20 in the ControlNet (10 ResnetBlocks x 2)
K3_SITES = 67
# K3 vs plain, both from the same bf16 inputs with f32 sums: the kernel
# rounds its output to bf16 (2^-8 relative), sums in another order: worst
# |diff| within 1e-2 of the plain output's largest |value|
K3_REL_TOL = 1e-2
# K4 (the VAE's GroupNorm + SiLU) against its plain version on the same
# inputs. Both sum the statistics in float32 in other orders (relative
# ~1e-6), which flips the bf16 rounding of the pre-activation or the
# output by one ulp (2^-8 relative) at ~1e-4 of the elements: relative L2
# gap within K4_REL_TOL of the plain output and worst |diff| within
# K4_WORST of its largest |value|. Float32 has no such flips (1e-5, 1e-4).
# The statistics themselves, mean and rstd [B, G]: relative L2 1e-5
K4_REL_TOL = {"bf16": 1e-3, "f32": 1e-5}
K4_WORST = {"bf16": 2.0 ** -6, "f32": 1e-4}
K4_STAT_TOL = 1e-5
# dweight and dbias (the per-channel partials, asked for when the VAE's
# weights train): sums of ~10^6 terms of both signs in other orders,
# relative L2 gap 1e-3
K4_WB_TOL = 1e-3
K4_EPS = 1e-6
# shapes outside the SD VAE's that K4 also runs on the card: the tiny test
# stack's VAE (C / G = 2 and 4, a 16-byte vector spanning 4 and 2 groups)
# in bf16, and the f32 path (weight_parity's VAE) at the stage-1 encode's
# smallest shape; ((B, C, H, W), groups, silu, dtype)
K4_EXTRA = (((4, 16, 64, 64), 8, True, "bf16"),
            ((4, 32, 32, 32), 8, True, "bf16"),
            ((4, 512, 64, 64), 32, True, "f32"))
# the tiny guidance stack at bf16 on the card against float32 on the CPU,
# worst |diff| over the largest |value|: bf16 rounding through the stack's
# depth costs ~2% (the same comparison with bf16 on the CPU), a layout or
# indexing fault O(1)
GUIDANCE_REF_TOL = 6e-2
# the denoise replayed from its CUDA graph against the eager call, worst
# |diff| over the largest |value|: the same kernels on the same inputs give
# 0; a library that chose another algorithm under capture stays within
# bf16's rounding
DENOISE_GRAPH_TOL = 1e-2
# idle seconds at each end of a profile whose device ops are counted one by
# one (check_denoise_graph)
PROFILE_MARGIN_S = 0.05
# f32 operations (an FMA counts 2) per (instance, pixel) pair up to the
# pixel's last contributor, as csrc/composite.cu computes the function with
# K1 at 2 and K2 at 4 pixels per thread. K1: the power from the column
# terms 4 (2 multiplies, 2 adds, unfused), times log2(e) 1, the column
# terms u, v 6 per thread and instance over 2 pixels 3, exp 1, min 1,
# 1 - alpha 1, T update 1, weight 1, 5 accumulations 10 -> 23. K2: power
# 4, times log2(e) 1, column terms 6 / 4 = 1.5, exp 1, min 1, 1 - alpha 1,
# reciprocal 1, T 1, weight 1, feat . gout 9, dpower 4, r update 2, the
# sums of dpower, dpower y, dpower y^2 5, the 4 colour and depth terms 8,
# and per thread and instance the six coefficient terms from those sums 3
# and the transposed reduction's adds 31 / 3 over 4 pixels 3.3 -> 44
OPS_PER_PAIR = {"fwd": 23, "bwd": 44}
# the first, one-pixel-per-thread kernels' counts (power 11 from the six
# coefficients, K2's 11 terms summed per pixel, a divide), printed beside
# as first_bound_ms for comparison with earlier bounds
FIRST_OPS_PER_PAIR = {"fwd": 26, "bwd": 54}
BYTES_PER_INSTANCE = 64  # one [16] f32 column of data
# K2's fused epilogue, per instance up to its tile's last contributor: the
# 8 B gidx read, the 24 B gather of mean2d, conic and opacity from packed
# and 40 B of atomics into d_packed; 37 f32 operations (the VJP of
# gaussian_power_coeffs: mean2d 8 + 8, conic 6 + 7 + 6, opacity 1; the
# reciprocal of the opacity 1)
EPILOGUE_BYTES = 8 + 24 + 40
EPILOGUE_OPS = 37
# tolerances kernel vs plain (both f32; the kernel composites sequentially,
# the plain version with a cumprod, so isolated pixels may flip across the
# 1/255 and T=1e-4 gates): q99 and worst case of |diff| per output row
FWD_TOL = {"rgb": 3e-4, "alpha": 3e-4, "depth": 2e-3}
WORST_FACTOR = 100.0
# d_packed [B, N, 10]: worst |diff| relative to the largest |value| of its
# column. The kernel sums each gaussian's terms over tiles with atomics in
# an order that changes from run to run, over pixels in another order than
# the plain version, and rebuilds T through ex2.approx / rcp.approx (2 ulp)
BWD_REL_TOL = 2e-3
# stages 2 and 3 at the recipe's sizes (configs/exp.yaml): 32 refine views
# at 1024^2 (elevation 17, distance 1.5, fovy 70), 8 of the 50 DDIM ladder
# steps, 8 denoise calls a step (anchors, keys, 6 dense groups of 4); 800
# stage-3 steps of 4 views with the one densify after step index 100, cut
# to S3_STEPS; the turntable is the eval orbit's test split (144 body and
# 144 head views)
HIRES = 1024
REFINE_VIEWS = 32
REFINE_STEPS = 8
REFINE_CALLS_PER_STEP = 8
S3_STEPS = 110
S3_WARMUP = 5
S3_D_MAX = 25  # RenderConfig() of stage 3 and the turntable
# the tiny stack's refine (1 step, 32 views at 32^2) at bf16 on the card
# against float32 on the CPU, worst |diff| on images in [0, 1]: bf16
# rounding through the VAE and the 8 denoise calls, which the same
# comparison with bf16 on the CPU shows too; a layout or row fault is O(1)
REFINE_REF_RES = 32
REFINE_REF_TOL = 6e-2
# share of the CPU output's pixels strictly inside (0, 1) that the
# comparison needs, so that vae_decode's clamp does not decide it (the
# same floor as the CPU parity test's)
REFINE_REF_INTERIOR = 0.2
# animation (gaussianip_tpu_torch/animation.py) on the final avatar: a
# seeded random motion ([ANIM_MOTION, 55, 3] axis-angle, sigma 0.05, key
# `poses`) on the synthetic body, ANIM_FRAMES frames at 1024^2 with --play
# --rotate; the bind at the SMPL-X sizes (10,475 vertices, 20,908 faces of
# a synthetic body) held against a dense evaluation over every face on a
# strided sample of BIND_SAMPLE points: |d| and the closest point within
# BIND_TOL (float32 rounding of O(1) coordinates is ~1e-7; a wrong face or
# region is O(0.01) or more)
ANIM_MOTION = 120
ANIM_FRAMES = 90
SMPLX_SIZES = (10475, 20908)
BIND_SAMPLE = 2000
BIND_TOL = 1e-5
# the animation-space refine (system/anim_refine.py) at the stage-1
# recipe's shapes: PTS_NUM canonical points on the A-pose surface of the
# SMPL-X-size body, capacity CAPACITY, 4 views at 512^2, K = 6, the
# SD1.5-width random guidance; AR_WARMUP + AR_STEPS steps
AR_WARMUP = 2
AR_STEPS = 4
# the side systems on the final avatar. Photo reconstruction
# (system/photo_recon.py) of a NeRF-synthetic-layout scene of it: the lego
# scene's train-split size and field of view (PR_TRAIN_VIEWS frames on the
# upper hemisphere, PR_TEST_VIEWS at elevation 30 degrees, radius
# PR_RADIUS, fovx PR_FOVX), rendered by the port at PhotoReconConfig()'s
# 512^2 (no resample on load); PhotoReconConfig()'s defaults cut to
# PR_ITERS of its 7000 iterations (the six densifies at 500..1000 and the
# SH raise at 1000), then PR_SH_STEPS steps at SH degree 3 and one opacity
# reset; the test views' PSNR must rise by PR_MIN_GAIN_DB. The export runs
# configs/exp.yaml's system.exporter (128^3, threshold 1.0, 1024^2
# texture, obj-mtl); the viewer answers VIEWER_REQUESTS requests of
# /render?size=512
PR_TRAIN_VIEWS = 100
PR_TEST_VIEWS = 20
PR_RADIUS = 4.0
PR_FOVX = 0.6911
PR_ITERS = 1001
PR_SH_STEPS = 5
PR_WARMUP = 5
PR_MIN_GAIN_DB = 3.0
VIEWER_SIZE = 512
VIEWER_REQUESTS = 3
# how far past the bounding box of the avatar's centres an exported vertex
# may lie, in grid cells (the splat's patch reaches 4 cells past a centre,
# so a lump of large opaque splats can pass one cell: the CPU rehearsal's
# untrained test body at opacity 0.95 reached 3.6; the trained avatar stays
# inside)
EXPORT_PAD_CELLS = 1.0
# the port's command line (gaussianip_tpu_torch/launch.py) on configs/
# exp.yaml with --stub-guidance at the recipe's sizes: stage 1 for
# CLI_STEPS steps with validation and a checkpoint after step index 10, a
# densify after 5 and a prune after 15; a --resume of it from that
# checkpoint (step 11) to CLI_STEPS; stage 2; stage 3 for CLI_STEPS steps
# in a child process (the turntable: the recipe's 144 + 144 test views)
CLI_STEPS = 20
CLI_CKPT_STEP = 11
CLI_OVERRIDES = (
    "trainer.log_every_n_steps=1", "trainer.val_check_interval=10",
    "trainer.ckpt_every_n_steps=10", "system.densify_prune_start_step=4",
    "system.densify_prune_end_step=9", "system.densify_prune_interval=5",
    "system.prune_only_start_step=9", "system.prune_only_end_step=16",
    "system.prune_only_interval=15")
CLI_STUB_SIZE = 64  # launch.py's default system.stub_image_size
CLI_TEST_FRAMES = 288
# the command line without --stub-guidance (phase cli:real) on a
# released-layout checkpoint set written from seeded random modules at the
# published widths: the SD1.5 UNet with a rank-128 IP-Adapter LoRA on every
# attention (float16; its up projections scaled by LORA_UP_SCALE, so that
# the folded weights keep the random stack's statistics), the ControlNet
# (float16), the VAE (float32), CLIP-L (12 x 768, 49,408 tokens) and the
# ViT-H/14 (32 x 1280, float16), VGG16 + the LPIPS heads. Stage 1 for
# CLI_REAL_STEPS steps at the recipe's sizes (one validation render and a
# checkpoint after step index 5), stage 2 in full, stage 3 for
# CLI_REAL_STEPS steps at 1024^2 and the turntable, then eval_avatar
CLI_REAL_STEPS = 10
CLI_REAL_OVERRIDES = ("trainer.log_every_n_steps=1",
                      "trainer.val_check_interval=5",
                      "trainer.ckpt_every_n_steps=5")
LORA_RANK = 128
LORA_UP_SCALE = 0.1
CLIP_L = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072,
              num_hidden_layers=12, num_attention_heads=12,
              max_position_embeddings=77, hidden_act="quick_gelu")
VIT_H = dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
             num_attention_heads=16, image_size=224, patch_size=14,
             hidden_act="gelu")
# the loaded stack against the source stack with the same (file-rounded,
# folded) weights, one ControlNet + UNet call on a CFG batch of 12 at 64^2
# latents: worst |diff| over the largest |value|
REAL_FWD_TOL = 1e-2
# scripts/eval_avatar.py's EVAL.json keys with both LPIPS checkpoints
EVAL_KEYS = {"n_views", "render_size", "psnr", "ssim", "l1", "ply",
             "lpips_vgg", "id_similarity", "id_similarity_backend"}
# data parallel (phase dp, gaussianip_tpu_torch/parallel/mesh.py): DP_RANKS
# gloo ranks on the one card through parallel.spawn, each rank's part
# against the single process run in rank 0 on the same inputs: stage 1 on
# the SD1.5-width random stack at 4 x 512^2 (2 views a rank), DP_STEPS
# steps with the densify after step index DP_DENSIFY_AT; stage 3 at 4 x
# 1024^2 with the random LPIPS, DP_S3_STEPS steps; refine_views on the 32
# handoff views at 1024^2, DP_REFINE_STEPS denoise step (dense groups of
# 8, split 4 + 4); then one stub-guided stage-1 step in a world-size-1
# NCCL group. The rank processes run attention on the fused backends
# (flash, memory-efficient), not cuDNN's, which gives each process its own
# result: scripts/probe_torch_dp.py found one UNet call of the refine on the
# same inputs 0.0115 apart in two processes (each process repeats itself to
# the bit; with flash or memory-efficient alone, equal), and so any two
# processes' refines up to ~0.05 apart with no data parallel involved.
# Tolerances, ranks against the single process:
#  * stage 1 in f32 on the stub guidance, on a camera batch whose depth
#    max lies in the last rank's views (dp_stage1_f32): one step with the
#    recipe's losses and one with the depth terms alone (lambda_sds 0,
#    lambda_opaque 1), where the batch's depth max sets the whole loss.
#    Each loss to DP_F32_LOSS_RTOL, m and the statistics within BWD_REL_TOL
#    (reassociated sums, K2's atomics). This is what holds the cross-rank
#    rules tightly: the global B, the depth max and its gradient (a
#    rank-local max or a gradient to every rank's own argmax fails it:
#    scripts/probe_torch_dp.py plants both), the offset gradient summed
#    before the norm;
#  * guided stage 1: each step's loss to DP_LOSS_RTOL; Adam's m and the
#    densify statistics after step 1, in relative L2 norm, within
#    DP_GUIDED_FACTOR times the stack's own sensitivity to the batch it
#    runs at (at least DP_GUIDED_MIN, f32 sums in another order), measured
#    in the same run (`guidance_half_batch_l2`: the SDS gradient to the
#    rendered views computed in two halves against the whole batch, no
#    data parallel involved). The bf16 stack rounds in other places at
#    half the batch, and the guidance scale of 7.5 on the difference of
#    two noise predictions magnifies that (on an H100 80GB HBM3 at 700 W:
#    ~5% in L2 for that sensitivity, 3-4% against the ranks, up to 6.2e-2
#    of the largest |value| in one element), so the worst element is
#    printed, not held; a fault of the group path (a local batch size or
#    depth max) is O(1) or systematic;
#    the count after the densify within DP_COUNT_RTOL (a gaussian at the
#    2e-4 threshold may go either way);
#  * stage 3 (f32; reassociated sums and K2's atomics): each loss to
#    DP_S3_RTOL, m and the statistics after step 1 within BWD_REL_TOL;
#  * the refine: worst |diff| on [0, 1] images within DP_REFINE_TOL. The
#    rank's VAE chunks and dense groups of 4 are the single process's and
#    the gathers exact, so the calls are the same and the views equal; a
#    fault of the split (a view's rows or caches crossed) moves whole
#    views;
#  * the NCCL step against the no-group step from one state and draws: the
#    loss equal, m within BWD_REL_TOL (K2's atomics).
DP_RANKS = 2
DP_STEPS = 3
DP_DENSIFY_AT = 1
DP_S3_STEPS = 2
DP_REFINE_STEPS = 1
DP_F32_LOSS_RTOL = 1e-5
DP_LOSS_RTOL = 1e-3
DP_GUIDED_FACTOR = 3.0
DP_GUIDED_MIN = 1e-4
DP_COUNT_RTOL = 1e-2
DP_S3_RTOL = 1e-3
DP_REFINE_TOL = 1e-6
# the last three tools, each run as a user runs it, in a child process:
# `python -m gaussianip_tpu_torch.bench_pipeline` (phase bench) with stage
# 3 cut to BENCH_S3_STEPS of 800 (the densify after step index 100
# included; PIPELINE_BENCH_TORCH.json holds an uncut run's line), every key
# of BENCH_KEYS present and finite and each stage's launches as its
# schedule makes them; `render_ply` (phase render_ply) on the final avatar
# at 1024^2, its PNG equal to the in-process render's and one K1 launch;
# `weight_parity compare` (phase weight_parity) on cli:real's set against a
# recording of the set's source modules at float32 on the CPU (each tensor
# rounded to its file's dtype), which must pass, then with
# PLANTED_TENSOR moved by PLANTED_SHIFT in a copy of the UNet file, which
# must fail unet_out and nothing else (the UNet's last conv, which no
# GroupNorm follows: one before it takes out the part of a shift that is
# constant over its group)
BENCH_S3_STEPS = 110
BENCH_KEYS = (
    "stage1_first_step_s", "stage1_step_ms", "stage1_2400_steps_min",
    "stage2_total_s_incl_compile", "stage2_wall_s", "stage3_wall_s",
    "pipeline_total_min", "vs_reference_40min",
    "splat_render_fwd_bwd_1024px_100k", "fwd_ms", "fwd_bwd_ms",
    "n_live_instances", "train_step_render_512_b4_ms", "unet_denoise_ms",
    "unet_denoise_steps_per_s", "pairs", "k1_ms", "k2_ms", "k1_bound_ms",
    "k2_bound_ms", "k1_share_of_bound", "k2_share_of_bound")
RENDER_PLY_VIEW = dict(azimuth=30.0, elevation=5.0, radius=1.8, fovy=70.0,
                       bg=(0.1, 0.2, 0.3))
PLANTED_TENSOR = "conv_out.weight"
PLANTED_SHIFT = 0.1
# tiled renderer vs the dense reference compositor on a small scene: worst
# gradient |diff| relative to the field's largest |gradient| (the JAX
# package's tiled compositor deviates from its dense oracle by 1.4e-3 on
# f_dc on the same scene on the CPU, the port's by the same amount)
ORACLE_GRAD_TOL = 5e-3


def log(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_entries(log: str):
    """(entry function, its `Used ... registers` and spill lines) per
    kernel in an `nvcc -Xptxas -v` log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


SASS_OPS = ("FFMA", "FMUL", "FADD", "MUFU", "FSEL", "SEL", "SHFL", "LDS",
            "STS", "LDG", "REDG", "BRA")


def sass_counts(lib: str, nvcc: str) -> dict:
    """Static SASS instruction counts of SASS_OPS per kernel of a built
    library (cuobjdump -sass, beside nvcc)."""
    import re
    from collections import Counter

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            out[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)", ln)
        if fn and m:
            out[fn][m.group(1)] += 1
    return {f: {"total": sum(c.values()), **{k: c[k] for k in SASS_OPS}}
            for f, c in out.items()}


def cuda_ms(fn, iters: int, warmup: int = 2, enqueue: bool = False):
    """CUDA-event ms per call of fn over `iters` calls; with `enqueue`,
    also the host's ms per call to return from fn (its enqueue time: where
    it is close to the event time, fn is bound by the host, not the
    device)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return (ms, enqueue_ms) if enqueue else ms


def device_ms(fn) -> float:
    """Device time of the kernels that one call of fn launches, summed
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum((getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages() if e.device_type == cuda) / 1e3


def build_scene(dev):
    import torch
    from gaussianip_tpu_torch.human.skeleton import Skeleton
    from gaussianip_tpu_torch.human.smplx import make_test_model
    from gaussianip_tpu_torch.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.ops.knn import mean_dist2_3nn

    sk = Skeleton(_test_model=make_test_model(np.random.default_rng(0),
                                              n_verts=2000, n_faces=3000,
                                              device=dev))
    sk.forward_smplx()
    sk.scale(-10)
    pts = sk.sample_smplx_points(PTS_NUM, seed=SEED)
    d2 = mean_dist2_3nn(torch.as_tensor(pts, device=dev))
    gs = create_from_pcd(pts, np.full((PTS_NUM, 3), 0.5, np.float32),
                         CAPACITY, d2, device=dev)
    return sk, gs


def quantile(v, q: float) -> float:
    """The q-quantile of v, from a strided sample of at most ~1M values."""
    import torch

    v = v.flatten()
    return float(torch.quantile(v[::max(1, v.numel() // 1_000_000)]
                                .float(), q))


def spread(v) -> dict:
    return {"max": float(v.max()), "p99": quantile(v, 0.99),
            "mean": round(float(v.double().mean()), 3)}


def check_kernels(gs, cams, rcfg, gen, tag: str, timing: bool):
    """K1 and the fused K2 against their plain versions on one camera
    batch; with `timing`, each kernel's time and its plain version's."""
    import torch
    from gaussianip_tpu_torch.render import composite_cuda as cc
    from gaussianip_tpu_torch.render.render import instance_data

    inst = instance_data(gs, cams, rcfg)
    data, bn, ntx = inst.data, inst.binning, inst.n_tiles_x
    starts, counts = bn.starts, bn.counts
    order = cc.heaviest_first(counts)  # as the render path
    out_k = cc.composite_fwd_cuda(data, starts, counts, order)
    out_p = cc.composite_fwd_plain(data, starts, counts)
    torch.cuda.synchronize()
    res = {}
    for name, rows in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                       ("alpha", slice(4, 5))):
        d = (out_k[:, :, rows] - out_p[:, :, rows]).abs().flatten()
        q99 = quantile(d, 0.99)
        mx = float(d.max())
        res[name] = (q99, mx)
        if not (q99 < FWD_TOL[name] and mx < WORST_FACTOR * FWD_TOL[name]):
            raise AssertionError(f"K1 {tag} {name}: q99 {q99} max {mx} vs "
                                 f"tol {FWD_TOL[name]}")
    last_eq = float((out_k[:, :, 5] == out_p[:, :, 5]).float().mean())
    gout = torch.randn(out_k.shape, generator=gen, device=out_k.device)
    gout[:, :, 5:] = 0.0  # the render path's gout has zero rows 5-7

    def fwd():
        return cc.composite_fwd_cuda(data, starts, counts, order)

    def bwd():
        return cc.composite_bwd_gaussians_cuda(
            data, inst.packed, bn.gidx, starts, counts, order, out_k, gout,
            ntx)

    def bwd_plain():
        return cc.composite_bwd_gaussians_plain(
            data, inst.packed, bn.gidx, bn.tile_of, starts, counts, out_k,
            gout, ntx, inst.n_tiles_y)

    dp_k = bwd()
    dp_p = bwd_plain()
    torch.cuda.synchronize()
    diff = (dp_k - dp_p).abs().amax(dim=(0, 1))
    rel = diff / dp_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    bwd_rel = float(rel.max())
    bwd_abs = float(diff.max())
    if not bwd_rel < BWD_REL_TOL:
        raise AssertionError(f"K2 {tag}: worst |diff|/column max per column "
                             f"{rel.tolist()} vs {BWD_REL_TOL}")
    live = int(counts.to(torch.int64).sum())
    # (instance, pixel) pairs the data needs walked: every pixel up to its
    # last contributor; instances K2 visits: each tile's up to its last
    # contributor
    last = out_k[:, :, 5].to(torch.int64)
    pairs = int((last + 1).sum())
    walk = (last.amax(dim=-1) + 1).flatten()
    touched = int(walk.sum())
    log(f"kernels:{tag}", live_instances=live,
        n_dropped=[int(x) for x in bn.n_dropped], pairs=pairs,
        touched_instances=touched,
        fwd_q99_max={k: v for k, v in res.items()},
        last_index_equal=round(last_eq, 6), bwd_max_abs=bwd_abs,
        bwd_rel_by_column=[float(f"{x:.3g}") for x in rel.tolist()])
    log(f"segments:{tag}", tiles=counts.numel(),
        empty=int((counts == 0).sum()), length=spread(counts),
        walk_to_last=spread(walk), pixel_walk=spread(last + 1))
    info = {"live": live, "pairs": pairs, "touched": touched, "fwd_err": max(
        v[1] for v in res.values()), "bwd_err": bwd_abs}
    if timing:
        info["fwd_ms"] = cuda_ms(fwd, 20)
        info["bwd_ms"] = cuda_ms(bwd, 20)
        info["order_ms"] = cuda_ms(lambda: cc.heaviest_first(counts), 20)
        info["fwd_plain_ms"] = cuda_ms(
            lambda: cc.composite_fwd_plain(data, starts, counts), 3, 1)
        info["bwd_plain_ms"] = cuda_ms(bwd_plain, 3, 1)
        out_bytes = counts.numel() * 8 * 256 * 4
        info["fwd_bytes"] = live * BYTES_PER_INSTANCE + out_bytes
        info["bwd_bytes"] = (touched * (BYTES_PER_INSTANCE + EPILOGUE_BYTES)
                             + 2 * out_bytes)
        for k in ("fwd", "bwd"):
            epilogue = touched * EPILOGUE_OPS if k == "bwd" else 0
            info[f"{k}_ops"] = pairs * OPS_PER_PAIR[k] + epilogue
            info[f"{k}_first_ops"] = pairs * FIRST_OPS_PER_PAIR[k] + epilogue
        log(f"timing:{tag}", **{k: info[k] for k in (
            "fwd_ms", "bwd_ms", "order_ms", "fwd_plain_ms",
            "bwd_plain_ms")})
    return info


def check_oracle(gs, dev):
    """Tiled renderer (K1/K2) against the dense reference compositor on a
    small input: images and gradients; the tiled render's forward and
    backward each launch their kernel once."""
    import torch
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   eval_orbit_batch)
    from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
    from gaussianip_tpu_torch.render.render import RenderConfig, render

    n, res = 300, 32
    small = gs.replace(**{f: getattr(gs, f)[:n].clone()
                          for f in PARAM_FIELDS}, n_active=n)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    small.opacity.uniform_(-2.0, 3.0, generator=g)
    ccfg = CameraSamplerConfig(eval_height=res, eval_width=res,
                               n_val_views=2)
    orbit = eval_orbit_batch(ccfg, "val", device=dev)
    cams = camera_from_c2w(orbit.c2w[:2], orbit.fovy[:2], res, res)
    bg = torch.zeros(3, device=dev)
    tgt = torch.rand((2, res, res, 3), generator=g, device=dev)

    def grads(cfg):
        leaves = {f: getattr(small, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        out = render(small.replace(**leaves), cams, bg, cfg)
        loss = ((out.rgb - tgt) ** 2).sum() + 0.1 * out.depth.sum()
        gr = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS])
        return out, dict(zip(PARAM_FIELDS, gr))

    (o_t, g_t), ran = count_launches(lambda: grads(RenderConfig(
        d_max=16, depth_key="exact2", sort_stable=True)))
    o_r, g_r = grads(RenderConfig(backend="reference"))
    check_launches("oracle", ran, {"K1": 1, "K2": 1})
    errs = {}
    for name, a, b, tol in (("rgb", o_t.rgb, o_r.rgb, 3e-4),
                            ("alpha", o_t.alpha, o_r.alpha, 3e-4),
                            ("depth", o_t.depth, o_r.depth, 2e-3)):
        d = (a - b).detach().abs().flatten()
        q99, mx = float(torch.quantile(d, 0.99)), float(d.max())
        errs[name] = (q99, mx)
        if not (q99 < tol and mx < 100 * tol):
            raise AssertionError(f"oracle {name}: q99 {q99} max {mx}")
    gerr = {}
    # (rotation is left out: the gaussians are isotropic, so its gradient
    # is zero up to rounding in both)
    for f in ("xyz", "f_dc", "scaling", "opacity"):
        # worst |diff| against the field's largest gradient: gate flips at
        # alpha = 1/255 and T = 1e-4 move single entries, not the field
        gerr[f] = float((g_t[f] - g_r[f]).abs().max()
                        / g_r[f].abs().max().clamp(min=1e-12))
        if not gerr[f] < ORACLE_GRAD_TOL:
            raise AssertionError(f"oracle grad {f}: {gerr[f]}")
    log("oracle", n=n, res=res, image_q99_max=errs, grad_rel_err=gerr,
        k1_k2_launches=[ran["K1"], ran["K2"]])


def profile_steps(ts, cfg, cam_cfg, rcfg, guidance, points3d, gen,
                  n: int = 3, tag: str = "profile"):
    """Device time by kernel over n steps (torch.profiler), and the device's
    busy share of the window's wall time."""
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.system import stage1 as s1

    step_fn = s1.make_train_step(cfg, cam_cfg, rcfg, AdamHyper(), guidance,
                                 points3d)
    state = [ts]

    def step():
        state[0], _ = step_fn(state[0], gen)

    return profile_window(step, n, tag)


def profile_window(step, n: int, tag: str):
    """Device time by kernel over n calls of step() (torch.profiler), the
    device's busy share of the window's wall time, and the check that no
    scatter-add ran. Returns (device ms per call, busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ops = [], []
    for e in prof.key_averages():
        if dev_us(e) > 0:
            (kernels if e.device_type == cuda else ops).append(
                (dev_us(e) / n / 1e3, e.count // n, e.key))
    busy = sum(ms for ms, _, _ in kernels)
    # the per-gaussian gradient reduction is K2's: no scatter-add runs
    scatter = [(ms, name) for ms, _, name in ops
               if name.startswith(("aten::scatter_add", "aten::index_add"))]
    log(tag, steps=n, wall_ms_per_step=round(wall_ms, 3),
        device_ms_per_step=round(busy, 3),
        device_busy_share=round(busy / wall_ms, 4),
        kernel_launches_per_step=sum(c for _, c, _ in kernels),
        scatter_add_rows=scatter)
    if scatter:
        raise AssertionError(f"{tag}: a scatter-add ran in the step: "
                             f"{scatter}")
    for title, rows in (("kernels", kernels), ("ops", ops)):
        for ms, count, name in sorted(rows, reverse=True)[:12]:
            print(f"  {title}: {ms:8.3f} ms/step x{count:<4d} {name[:100]}",
                  flush=True)
    return busy, busy / wall_ms


def view_aux(b: int, dev):
    """Camera metadata of b views around the body (the prompt table's
    inputs)."""
    import torch

    zeros = torch.zeros(b, device=dev)
    return {"all_vis": zeros, "elevation": zeros,
            "azimuth": torch.linspace(-170, 170, b, device=dev),
            "center": zeros, "camera_distances": zeros + 1.5}


def collect_conv_sites(models, fn):
    """Every stride-1 Conv3x3 call in `models` while fn() runs, in call
    order, as (module, input shape), from forward pre-hooks; a forward
    that a CUDA graph's capture runs (the guidance denoise's first call)
    calls nothing on the device and is left out."""
    import torch
    from gaussianip_tpu_torch.ops.conv3x3 import Conv3x3
    from gaussianip_tpu_torch.utils.profiling import capturing

    sites, hooks = [], []

    def hook(mod, args):
        if not capturing():
            sites.append((mod, tuple(args[0].shape)))

    for model in models:
        for m in model.modules():
            if isinstance(m, Conv3x3) and m.stride == 1:
                hooks.append(m.register_forward_pre_hook(hook))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return sites


def conv_sites(guidance, gen, batch: int, res: int, dev="cuda"):
    """Every stride-1 Conv3x3 call of one guidance call on `batch` views."""
    import torch

    def run():
        draws = guidance.sample_noise(gen, (batch, res, res, 3), dev)
        rgb = torch.rand((batch, res, res, 3), generator=gen, device=dev)
        with torch.no_grad():
            guidance(0, draws, rgb, torch.zeros_like(rgb),
                     view_aux(batch, dev))

    return collect_conv_sites((guidance.models.controlnet,
                               guidance.models.unet), run)


def check_k3(sites, gen, dev="cuda", tag: str = "k3"):
    """K3 against its plain version at every distinct (Ci, Co, H, W) of the
    guided step's conv sites, on the site's own weights and a N(0, 1) bf16
    input at the site's batch, through the variant the gate names; dx (the
    autograd backward, K3 on the rotated weights) at the largest shape.
    Each shape is timed, in turns and twice, as the gated variant (`ms`),
    the general variant, the first port's kernel (`prev_ms`), and F.conv2d
    (channels_last bf16), then once as the plain version. Returns the
    per-step sums."""
    import torch
    import torch.nn.functional as F
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3
    from gaussianip_tpu_torch.ops.conv3x3 import conv3x3

    shapes = {}
    for mod, shp in sites:
        key = (shp[1], mod.weight.shape[0], shp[2], shp[3])
        if key not in shapes:
            shapes[key] = {"mod": mod, "batch": shp[0], "count": 0}
        shapes[key]["count"] += 1
    tot = {"ms": 0.0, "prev_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flop": 0.0, "bytes": 0.0, "launches": 0, "max_abs_err": 0.0,
           "ms_8x8": 0.0, "prev_ms_8x8": 0.0, "launches_8x8": 0}
    rows = []
    for (ci, co, h, w), e in sorted(shapes.items()):
        b, mod = e["batch"], e["mod"]
        x = torch.randn((b, ci, h, w), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = mod.weight.detach().to(torch.bfloat16)
        bias = mod.bias.detach().float().contiguous()
        variant = k3.k3_variant(ci, co)
        wp = k3.pack_weight(mod.weight.detach())
        wg = k3.pack_weight(mod.weight.detach(), variant="general")
        y, ran = count_launches(lambda: k3.conv3x3_cuda(x, wp, bias))
        check_launches(f"K3 {ci}->{co}", ran, {f"K3_{variant}": 1})
        yp = k3.conv3x3_plain(x, wb, bias)
        torch.cuda.synchronize()
        err = float((y.float() - yp.float()).abs().max())
        scale = float(yp.float().abs().max())
        if not err <= K3_REL_TOL * scale:
            raise AssertionError(f"K3 {ci}->{co} at {h}x{w}: max |diff| "
                                 f"{err} vs {K3_REL_TOL} x {scale}")
        runs = {"ms": lambda: k3.conv3x3_cuda(x, wp, bias),
                "prev_ms": lambda: k3.conv3x3_general(x, wg, bias),
                "library_ms": lambda: F.conv2d(
                    x, wb, bias.to(torch.bfloat16), padding=1)}
        times = {k: [] for k in runs}
        for _ in range(2):
            for k, fn in runs.items():
                times[k].append(cuda_ms(fn, 10))
        t = {k: float(np.mean(v)) for k, v in times.items()}
        t["plain_ms"] = cuda_ms(lambda: k3.conv3x3_plain(x, wb, bias), 2, 1)
        flop = 2.0 * b * h * w * ci * co * 9
        nbytes = 2.0 * (b * h * w * (ci + co) + 9 * ci * co)
        bound_ms = max(flop / PEAK_BF16_OPS, nbytes / PEAK_BYTES) * 1e3
        c = e["count"]
        for k, v in (*t.items(), ("flop", flop), ("bytes", nbytes)):
            tot[k] += c * v
        if h == 8:
            tot["ms_8x8"] += c * t["ms"]
            tot["prev_ms_8x8"] += c * t["prev_ms"]
            tot["launches_8x8"] += c
        tot["launches"] += c
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        rows.append((ci, co, h, w, c, flop))
        plan = k3.k3_plan(b, h, w, ci, co) if variant == "hopper" else None
        log(tag, shape=f"{b}x{ci}x{h}x{w}->{co}", sites=c, variant=variant,
            plan=plan and {"bn": plan.bn, "splits": plan.splits,
                           "ctas": plan.units},
            ms=round(t["ms"], 4), prev_ms=round(t["prev_ms"], 4),
            conv2d_ms=round(t["library_ms"], 4),
            plain_ms=round(t["plain_ms"], 4), bound_ms=round(bound_ms, 4),
            tflops=round(flop / t["ms"] / 1e9, 1),
            prev_tflops=round(flop / t["prev_ms"] / 1e9, 1),
            max_abs_err=err, rel_err=err / scale)
    if tot["launches"] != K3_SITES:
        raise AssertionError(f"{tag}: {tot['launches']} conv sites per "
                             f"call, want {K3_SITES}")
    # dx through the autograd Function at the largest shape by FLOP
    ci, co, h, w, *_ = max(rows, key=lambda r: r[-1])
    mod = shapes[(ci, co, h, w)]["mod"]
    b = shapes[(ci, co, h, w)]["batch"]
    x = torch.randn((b, ci, h, w), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)

    def fwd_bwd():
        y = conv3x3(x, mod.weight.detach())
        g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
        y.backward(g)
        return g

    g, ran = count_launches(fwd_bwd)
    wt = mod.weight.detach().flip(2, 3).transpose(0, 1).to(torch.bfloat16)
    dxp = k3.conv3x3_plain(g, wt)
    torch.cuda.synchronize()
    dx_variant = k3.k3_variant(co, ci)
    check_launches("K3 dx", ran, {f"K3_{dx_variant}": 1 + (
        k3.k3_variant(ci, co) == dx_variant)})
    dx_err = float((x.grad.float() - dxp.float()).abs().max())
    dx_scale = float(dxp.float().abs().max())
    if not dx_err <= K3_REL_TOL * dx_scale:
        raise AssertionError(f"K3 dx {ci}->{co} at {h}x{w}: {dx_err} vs "
                             f"{K3_REL_TOL} x {dx_scale}")
    # the host's cost per call of each path into the conv, at the smallest
    # shape (enqueue time of 100 calls, the device idle behind them)
    key = min(shapes, key=lambda k: k[0] * k[1] * k[2] * k[3])
    small = shapes[key]
    xs = torch.randn((small["batch"], key[0], key[2], key[3]), generator=gen,
                     device=dev).to(torch.bfloat16).contiguous(
                         memory_format=torch.channels_last)
    wf, bf = small["mod"].weight.detach(), small["mod"].bias.detach()
    wp, wg = k3.pack_weight(wf), k3.pack_weight(wf, variant="general")
    wb, bias = wf.to(torch.bfloat16), bf.float()
    host = {name: cuda_ms(fn, 100, 5, enqueue=True)[1] * 1e3 for name, fn in (
        ("conv3x3_cuda", lambda: k3.conv3x3_cuda(xs, wp, bias)),
        ("conv3x3_general", lambda: k3.conv3x3_general(xs, wg, bias)),
        ("conv3x3_same", lambda: k3.conv3x3_same(xs, wf, bf)),
        ("conv2d", lambda: F.conv2d(xs, wb, bias.to(torch.bfloat16),
                                    padding=1)))}
    log(f"{tag}:host", shape=f"{small['batch']}x{key[0]}x{key[2]}x{key[3]}->"
        f"{key[1]}", us_per_call={k: round(v, 2) for k, v in host.items()})
    t_ops = tot["flop"] / PEAK_BF16_OPS * 1e3
    t_bytes = tot["bytes"] / PEAK_BYTES * 1e3
    tot["bound_ms"] = max(t_ops, t_bytes)
    tot["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"{tag}:step", sites=tot["launches"], distinct_shapes=len(rows),
        ms=round(tot["ms"], 3), prev_ms=round(tot["prev_ms"], 3),
        conv2d_ms=round(tot["library_ms"], 3),
        plain_ms=round(tot["plain_ms"], 3),
        ms_over_prev=round(tot["ms"] / tot["prev_ms"], 4),
        ms_over_conv2d=round(tot["ms"] / tot["library_ms"], 4),
        launches_8x8=tot["launches_8x8"], ms_8x8=round(tot["ms_8x8"], 3),
        prev_ms_8x8=round(tot["prev_ms_8x8"], 3), tflop=tot["flop"] / 1e12,
        gbytes=tot["bytes"] / 1e9, bound_ms=round(tot["bound_ms"], 4),
        bound_by=tot["bound_by"], dx_shape=f"{b}x{co}x{h}x{w}->{ci}",
        dx_variant=dx_variant, dx_max_abs_err=dx_err,
        dx_rel_err=dx_err / dx_scale)
    return tot


def k4_sites(vae, fn) -> dict:
    """{((B, C, H, W), groups, silu): calls} of the VAE's GroupNorms
    (VAEGroupNorm, K4) while fn() runs, from forward pre-hooks."""
    import torch
    from gaussianip_tpu_torch.diffusion.vae import VAEGroupNorm

    seen, hooks = {}, []

    def hook(mod, args):
        key = (tuple(args[0].shape), mod.num_groups, mod.silu)
        seen[key] = seen.get(key, 0) + 1

    for m in vae.modules():
        if isinstance(m, VAEGroupNorm):
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def check_k4(vae, gen, dev="cuda") -> dict:
    """K4 against its plain version (ops/groupnorm_cuda.py) at every
    distinct GroupNorm shape of the stage-1 encode (4 x 512^2, forward and
    backward) and of a refine chunk's encode (2 x 1024^2) and decode (2
    latents at 128^2, forward), then at K4_EXTRA, on N(0.5, 2^2) inputs,
    weights 1 + N(0, 0.5^2) and biases N(0, 0.3^2); a rerun gives the same
    bits (no atomics), and the backward asked for dweight and dbias too
    gives the same dx. Each shape is timed as
    K4, as the plain version (today's formula: group_norm + F.silu,
    forward and autograd's backward) and as F.group_norm + F.silu (the
    library yardstick), beside K4's bound: two passes each way at 3.35
    TB/s (forward 3, backward 5 element sizes an element; `bound_once_ms`:
    each input read once, 2 and 3). Returns the stage-1 step's and the
    refine chunk's sums over their calls."""
    import torch
    import torch.nn.functional as F
    from gaussianip_tpu_torch.diffusion.norm import group_norm
    from gaussianip_tpu_torch.ops import groupnorm_cuda as k4

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cl = torch.channels_last
    sites = []  # (tag, shape, groups, silu, dtype name, backward, calls)
    for tag, backward, fn in (
            ("stage1_encode", True, lambda: vae.encode(torch.zeros(
                (BATCH, 3, RES, RES), device=dev))),
            ("refine_encode", False, lambda: vae.encode(torch.zeros(
                (2, 3, HIRES, HIRES), device=dev))),
            ("refine_decode", False, lambda: vae.decode(torch.zeros(
                (2, vae.cfg.latent_channels, HIRES // vae.cfg.downscale,
                 HIRES // vae.cfg.downscale), device=dev)))):
        for (shape, groups, silu), calls in sorted(k4_sites(vae,
                                                            fn).items()):
            sites.append((tag, shape, groups, silu, "bf16", backward, calls))
    if sum(c for t, *_, c in sites if t == "stage1_encode") != 22:
        raise AssertionError(f"k4: the stage-1 encode ran "
                             f"{[s for s in sites if s[0] == 'stage1_encode']}"
                             f", not 22 GroupNorms")
    sites += [("extra", *e, True, 1) for e in K4_EXTRA]

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp(min=1e-30))

    tot = {}
    for tag, shape, groups, silu, dt, backward, calls in sites:
        dtype = dtypes[dt]
        b, c, h, w = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(
            dtype).contiguous(memory_format=cl)
        weight = 1.0 + 0.5 * torch.randn(c, generator=gen, device=dev)
        bias = 0.3 * torch.randn(c, generator=gen, device=dev)
        args = (weight, bias, groups, K4_EPS, silu)
        y, mean, rstd = k4.groupnorm_fwd_cuda(x, *args)
        py, pmean, prstd = k4.groupnorm_fwd_plain(x, *args)
        errs = {"y": (y, py)}
        if backward:
            dy = torch.randn(shape, generator=gen, device=dev).to(
                dtype).contiguous(memory_format=cl)
            bwd_args = (weight, bias, mean, rstd, groups, silu, False)
            dx = k4.groupnorm_bwd_cuda(dy, x, *bwd_args)[0]
            pdx, pdw, pdb = k4.groupnorm_bwd_plain(
                dy, x, weight, bias, pmean, prstd, groups, silu, True)
            errs["dx"] = (dx, pdx)
            wdx, dw, db = k4.groupnorm_bwd_cuda(dy, x, *bwd_args[:-1], True)
            wb = {"dweight_rel": rel(dw, pdw), "dbias_rel": rel(db, pdb)}
            if not torch.equal(wdx, dx) or max(wb.values()) > K4_WB_TOL:
                raise AssertionError(f"k4 {tag} {shape}: with dweight and "
                                     f"dbias: dx equal "
                                     f"{torch.equal(wdx, dx)}, {wb}")
            del wdx, dw, db, pdw, pdb
        rerun = {"y": (k4.groupnorm_fwd_cuda(x, *args)[0], y)}
        if backward:
            rerun["dx"] = (k4.groupnorm_bwd_cuda(dy, x, *bwd_args)[0], dx)
        if not all(torch.equal(a, b) for a, b in rerun.values()):
            raise AssertionError(f"k4 {tag} {shape}: a rerun changed bits")
        del rerun
        torch.cuda.synchronize()
        got = {"mean_rel": rel(mean, pmean), "rstd_rel": rel(rstd, prstd)}
        if max(got.values()) > K4_STAT_TOL:
            raise AssertionError(f"k4 {tag} {shape}: statistics {got}")
        for name, (a, p) in errs.items():
            got[f"{name}_rel"] = rel(a, p)
            got[f"{name}_worst"] = float((a.float() - p.float()).abs().max()
                                         / p.float().abs().max())
            if not (got[f"{name}_rel"] <= K4_REL_TOL[dt]
                    and got[f"{name}_worst"] <= K4_WORST[dt]):
                raise AssertionError(f"k4 {tag} {shape} G={groups} "
                                     f"silu={silu} {dt}: {name} {got}")
        del y, py, errs
        if backward:
            del dx, pdx

        def ref(t):
            out = group_norm(t, weight, bias, groups, K4_EPS)
            return F.silu(out) if silu else out

        wl, bl = weight.to(dtype), bias.to(dtype)

        def lib(t):
            out = F.group_norm(t, groups, wl, bl, K4_EPS)
            return F.silu(out) if silu else out

        def fwd_bwd(f):
            xg = x.detach().requires_grad_(True)
            torch.autograd.grad(f(xg), xg, dy)

        iters = max(3, min(50, int(4e8 // x.numel())))
        n_el, size = x.numel(), x.element_size()
        row = {"ms": cuda_ms(lambda: k4.groupnorm_fwd_cuda(x, *args), iters),
               "bound_ms": 3 * n_el * size / PEAK_BYTES * 1e3,
               "bound_once_ms": 2 * n_el * size / PEAK_BYTES * 1e3}
        with torch.no_grad():
            row["plain_ms"] = cuda_ms(lambda: ref(x), max(1, iters // 8))
            row["library_ms"] = cuda_ms(lambda: lib(x), iters)
        if backward:
            row["bwd_ms"] = cuda_ms(
                lambda: k4.groupnorm_bwd_cuda(dy, x, *bwd_args), iters)
            row["bwd_bound_ms"] = 5 * n_el * size / PEAK_BYTES * 1e3
            row["bwd_bound_once_ms"] = 3 * n_el * size / PEAK_BYTES * 1e3
            row["bwd_plain_ms"] = cuda_ms(lambda: fwd_bwd(ref), max(
                1, iters // 8)) - row["plain_ms"]
            row["bwd_library_ms"] = cuda_ms(lambda: fwd_bwd(lib), iters) \
                - row["library_ms"]
        if backward:
            got.update(wb)
        log("k4", site=tag, shape=list(shape), groups=groups, silu=silu,
            dtype=dt, calls=calls, **{k: round(v, 4) for k, v in row.items()},
            share_of_bound=round(row["bound_ms"] / row["ms"], 4),
            bwd_share_of_bound=round(row["bwd_bound_ms"] / row["bwd_ms"], 4)
            if backward else None, **{k: float(f"{v:.3g}")
                                      for k, v in got.items()})
        acc = tot.setdefault(tag, {})
        for k, v in row.items():
            acc[k] = acc.get(k, 0.0) + calls * v
        acc["launches"] = acc.get("launches", 0) + calls * (
            k4.FWD_KERNELS + (k4.BWD_KERNELS if backward else 0))
        del x, mean, rstd, pmean, prstd
        torch.cuda.empty_cache()
    tot.pop("extra")
    for tag, acc in tot.items():
        acc["share_of_bound"] = acc["bound_ms"] / acc["ms"]
        if "bwd_ms" in acc:
            acc["bwd_share_of_bound"] = acc["bwd_bound_ms"] / acc["bwd_ms"]
        log("k4:" + tag, **{k: round(v, 4) for k, v in acc.items()})
    return tot


# K5 (the VAE's single-head attention, d = 512) against its plain version
# on the same inputs; ((B, N, d), backward, what runs it)
K5_SHAPES = (((4, 16384, 512), True, "sdxl_encode"),
             ((4, 4096, 512), True, "sd15_encode"),
             ((2, 16384, 512), False, "refine_chunk"),
             ((3, 1000, 32), True, "tiny_b3"),
             ((1, 200, 32), True, "tiny_b1"))
# bf16: both sides round P (dS) and the outputs to bf16 and sum S, dP and
# the products in float32 in other orders (~1e-6 relative), which flips
# the rounding of a few elements by one ulp (2^-8 relative): relative L2
# gap within 1e-2, worst |diff| within 2^-5 of the plain output's largest
# |value|. float32 (no TF32 on either side): sum order alone, 1e-4 / 1e-3.
# lse: absolute 1e-4 (float32 sums of N terms; lse ~ log N + max S).
K5_REL_TOL = {"bf16": 1e-2, "f32": 1e-4}
K5_WORST = {"bf16": 2.0 ** -5, "f32": 1e-3}
K5_LSE_TOL = 1e-4


def check_k5(gen, dev="cuda", shapes=K5_SHAPES,
             dtypes=("bf16", "f32")) -> dict:
    """K5 against its plain version (ops/vae_attention_cuda.py) at the VAE's
    attention shapes (K5_SHAPES), in bf16 and float32, on N(0, 1) q, k, v
    (scores of unit spread at d = 512: the softmax is neither flat nor
    one-hot) and N(0, 1) dO: o and lse forward, dq / dk / dv backward; a
    rerun gives the same bits (K5 has no atomics; its products run on
    cuBLAS). Each shape is timed as K5, as the plain version and as SDPA
    (`library_ms`: the memory-efficient backend takes a 512-wide head)
    beside the bound (forward 4, backward 10 B N^2 d operations at the bf16
    or float32 peak). Returns {tag: {dtype: row}}."""
    import torch
    import torch.nn.functional as F
    from gaussianip_tpu_torch.ops import vae_attention_cuda as k5

    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    peak = {"bf16": PEAK_BF16_OPS, "f32": PEAK_F32_OPS}

    def plain_fwd(q, k, v):  # a view at a time: S is [N, N] float32
        outs = [k5.attention_fwd_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                for i in range(q.shape[0])]
        return torch.cat([o for o, _ in outs]), torch.cat([l for _, l in outs])

    def plain_bwd(do, q, k, v, o, lse):
        outs = [k5.attention_bwd_plain(*(t[i:i + 1] for t in (do, q, k, v, o,
                                                               lse)))
                for i in range(q.shape[0])]
        return tuple(torch.cat(g) for g in zip(*outs))

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp(min=1e-30))

    out = {}
    for shape, backward, tag in shapes:
        for dt in dtypes:
            dtype = types[dt]
            b, n, d = shape
            q, k, v, do = (torch.randn(shape, generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(4))
            o, lse = k5.attention_fwd_cuda(q, k, v)
            po, plse = plain_fwd(q, k, v)
            got = {"lse_abs": float((lse - plse).abs().max())}
            pairs = {"o": (o, po)}
            same = torch.equal(k5.attention_fwd_cuda(q, k, v)[0], o)
            if backward:
                grads = k5.attention_bwd_cuda(do, q, k, v, o, lse)
                pgrads = plain_bwd(do, q, k, v, o, lse)
                pairs.update(zip(("dq", "dk", "dv"), zip(grads, pgrads)))
                again = k5.attention_bwd_cuda(do, q, k, v, o, lse)
                same = same and all(torch.equal(x, y)
                                    for x, y in zip(again, grads))
                del again, pgrads
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"k5 {tag} {shape} {dt}: a rerun "
                                     f"changed bits")
            bad = got["lse_abs"] > K5_LSE_TOL
            for name, (a, p) in pairs.items():
                got[f"{name}_rel"] = rel(a, p)
                got[f"{name}_worst"] = float((a.float() - p.float()).abs().max()
                                             / p.float().abs().max())
                bad |= not (got[f"{name}_rel"] <= K5_REL_TOL[dt]
                            and got[f"{name}_worst"] <= K5_WORST[dt])
            if bad:
                raise AssertionError(f"k5 {tag} {shape} {dt}: {got}")
            del pairs, po, plse
            if backward:
                del grads

            qh, kh, vh = (t[:, None] for t in (q, k, v))
            ops = b * n * n * d
            iters = max(2, min(20, int(2e12 // (4 * ops))))
            row = {"ms": cuda_ms(lambda: k5.attention_fwd_cuda(q, k, v),
                                 iters),
                   "bound_ms": 4 * ops / peak[dt] * 1e3,
                   "plain_ms": cuda_ms(lambda: plain_fwd(q, k, v), 1, 1),
                   "library_ms": cuda_ms(
                       lambda: F.scaled_dot_product_attention(qh, kh, vh),
                       iters)}
            if backward:
                row["bwd_ms"] = cuda_ms(
                    lambda: k5.attention_bwd_cuda(do, q, k, v, o, lse), iters)
                row["bwd_bound_ms"] = 10 * ops / peak[dt] * 1e3
                row["bwd_plain_ms"] = cuda_ms(
                    lambda: plain_bwd(do, q, k, v, o, lse), 1, 1)
                qg, kg, vg = (t.detach().requires_grad_(True)
                              for t in (qh, kh, vh))

                def lib_fwd_bwd():
                    y = F.scaled_dot_product_attention(qg, kg, vg)
                    torch.autograd.grad(y, (qg, kg, vg), do[:, None])

                row["bwd_library_ms"] = cuda_ms(lib_fwd_bwd, iters) \
                    - row["library_ms"]
            share = {"share_of_bound": row["bound_ms"] / row["ms"]}
            if backward:
                share["bwd_share_of_bound"] = row["bwd_bound_ms"] \
                    / row["bwd_ms"]
            log("k5", site=tag, shape=list(shape), dtype=dt,
                **{k_: round(v_, 4) for k_, v_ in {**row, **share}.items()},
                **{k_: float(f"{v_:.3g}") for k_, v_ in got.items()})
            out.setdefault(tag, {})[dt] = {**row, **share}
            del q, k, v, do, o, lse, qh, kh, vh
            torch.cuda.empty_cache()
    return out


def check_guidance_reference(dev="cuda") -> dict:
    """The tiny guidance stack (system/pipeline.py:build_stub_guidance_stack)
    at bf16 on the card, every stride-1 conv through K3, against the same
    weights at float32 on the CPU, the path the CPU tests hold against the
    JAX package: the VAE latents of 4 renders at 64^2 and the gradient of a
    random projection of them to the renders, and one ControlNet + UNet
    pass on the 12-sample CFG batch. Returns each output's worst |diff|
    relative to its largest |value|."""
    import torch
    from gaussianip_tpu_torch.system.pipeline import (
        build_stub_guidance_stack)

    args = ("a person", "bad quality", 64, SEED)
    ref = build_stub_guidance_stack(*args, device="cpu")
    card = build_stub_guidance_stack(*args, device=dev, dtype=torch.bfloat16)
    for a, b in zip(card.models, ref.models):
        a.load_state_dict(b.state_dict())
    g = torch.Generator().manual_seed(SEED)
    b = 4
    rgb = torch.rand((b, 64, 64, 3), generator=g)
    eps = torch.randn(ref.latent_shape(b), generator=g)
    wz = torch.randn(ref.latent_shape(b), generator=g)
    lat = torch.randn(ref.latent_shape(3 * b), generator=g)
    ctrl = torch.rand((3 * b, 3, 64, 64), generator=g)
    t = torch.randint(20, 800, (3 * b,), generator=g)

    def run(guid, d):
        x = rgb.to(d, copy=True).requires_grad_(True)
        z = guid.encode_images(x, eps.to(d))
        (z * wz.to(d)).sum().backward()
        with torch.no_grad():
            e = guid.predict_noise(lat.to(d), ctrl.to(d), t.to(d),
                                   guid._context(view_aux(b, d), b))
        return [v.detach().float().cpu().clone() for v in (z, x.grad, e)]

    outs = [run(ref, "cpu")]
    on_card, launches = count_launches(lambda: run(card, dev), dev)
    outs.append(on_card)
    if launches["K3"] == 0 or launches["K3_general"] == 0:
        raise AssertionError(f"the card's tiny stack did not run K3's "
                             f"general variant: {launches}")
    errs = {}
    for name, r, c in zip(("latents", "d_rgb", "denoise"), *outs):
        errs[name] = float((c - r).abs().max() / r.abs().max())
        if not errs[name] <= GUIDANCE_REF_TOL:
            raise AssertionError(f"guidance {name}: card bf16 vs CPU f32 "
                                 f"{errs[name]} > {GUIDANCE_REF_TOL}")
    log("guidance_reference", rel_err=errs, tol=GUIDANCE_REF_TOL,
        launches=launches)
    return errs


def guided_layers(guidance, gen, batch: int, res: int, dev="cuda"):
    """CUDA-event times of the guidance's two layers at the guided step's
    shapes: the VAE encode of `batch` renders, forward and backward to
    the renders, and one ControlNet + UNet pass on the 3 x batch CFG
    batch; beside each, the host's enqueue time and the device time of its
    kernels (profiler)."""
    import torch

    rgb = torch.rand((batch, res, res, 3), generator=gen, device=dev,
                     requires_grad=True)
    draws = guidance.sample_noise(gen, rgb.shape, dev)
    lat = torch.randn(guidance.latent_shape(3 * batch), generator=gen,
                      device=dev)
    ctrl = torch.rand((3 * batch, 3, res, res), generator=gen, device=dev)
    t = torch.randint(20, 800, (3 * batch,), generator=gen, device=dev)
    ctx = guidance._context(view_aux(batch, dev), batch)

    def vae():
        z = guidance.encode_images(rgb, draws["eps"])
        torch.autograd.grad(z, rgb, torch.ones_like(z))

    def denoise():
        with torch.no_grad():
            guidance.predict_noise(lat, ctrl, t, ctx)

    out = {}
    for name, fn in (("vae_fwd_bwd", vae), ("denoise", denoise)):
        out[f"{name}_ms"], out[f"{name}_enqueue_ms"] = cuda_ms(
            fn, 3, 1, enqueue=True)
        out[f"{name}_device_ms"] = device_ms(fn)
    return out


def check_denoise_graph(guidance, gen, batch: int, res: int, dev="cuda",
                        reps: int = 10) -> dict:
    """The guidance denoise from its CUDA graph (guidance/graph.py) against
    the eager predict_noise at the guided step's shapes (CFG batch 3 x
    batch at (res / 8)^2 latents): a fresh DenoiseGraph captures on one
    input set and replays two others, each held against predict_noise on
    the same inputs (a stale static buffer fails the second). Counts the K3
    launches of a replay through the counters (which add the capture's
    count at each replay: no Python runs) and of an eager call (each launch
    counted as it is made), and the graph's use (graph.USE); reads the
    peak memory of the capture, the device ms a call of the eager call and
    of a replay over `reps` calls back to back (CUDA events), and the host
    us of each (the median of `reps` calls, each on an idle device). Then
    profiles one eager call and one replay on the same inputs, the eager
    call's inputs copied as the replay copies them into its buffers, and
    holds every device op the profiler lists (kernels and copies by name,
    memsets together) at the same count in both: a capture that dropped or
    rerouted a kernel fails here, where the counters could not see it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussianip_tpu_torch.guidance.graph import DenoiseGraph

    ctx = guidance._context(view_aux(batch, dev), batch)

    def inputs():
        return (torch.randn(guidance.latent_shape(3 * batch), generator=gen,
                            device=dev),
                torch.rand((3 * batch, 3, res, res), generator=gen,
                           device=dev),
                torch.randint(20, 800, (3 * batch,), generator=gen,
                              device=dev),
                ctx + 0.1 * torch.randn(ctx.shape, generator=gen,
                                        device=dev).to(ctx.dtype))

    graphs = DenoiseGraph()
    sets = [inputs() for _ in range(3)]
    use = dict(DENOISE_GRAPH_USE)
    diffs, rel, ran = [], [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, first = count_launches(lambda: graphs(guidance.predict_noise,
                                                 *sets[0]))
        peak = torch.cuda.max_memory_allocated()
        for args in sets[1:]:
            got, n = count_launches(
                lambda: graphs(guidance.predict_noise, *args).clone())
            want = guidance.predict_noise(*args)
            diffs.append(float((got - want).abs().max()))
            rel.append(diffs[-1] / float(want.abs().max()))
            ran.append(n)
        replay = lambda: graphs(guidance.predict_noise, *sets[1])
        eager = lambda: guidance.predict_noise(*sets[1])
        _, eager_n = count_launches(eager)
        times = {}
        for name, fn in (("eager", eager), ("replay", replay)):
            times[f"{name}_device_ms"] = round(cuda_ms(fn, reps, 1), 3)
            host = []
            for _ in range(reps):  # each call's enqueue on an idle device
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append(time.perf_counter() - t0)
            times[f"{name}_host_us"] = round(float(np.median(host)) * 1e6,
                                             1)
        cuda = torch.autograd.DeviceType.CUDA

        def listed(fn):
            """({device op: its count} in one call of fn, host us). The
            device idles PROFILE_MARGIN_S inside the profile before and
            after the call: the profiler drops device records that its
            clock places before the window opens, and without the margin
            the call's first records (its copies, the time embedding)
            went missing now and then. The profiler names a graph's memset
            nodes by their element width ("memset32") and an eager one
            "Memset (Device)": memsets count as one op, every kernel and
            copy by its own name."""
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                t0 = time.perf_counter()
                fn()
                us = (time.perf_counter() - t0) * 1e6
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            ops = {}
            for e in prof.key_averages():
                if e.device_type == cuda:
                    k = "memset" if e.key.lower().startswith("memset") \
                        else e.key
                    ops[k] = ops.get(k, 0) + e.count
            return ops, us

        ops_e, _ = listed(lambda: guidance.predict_noise(
            *(a.clone() for a in sets[1])))
        ops_r, profiled_us = listed(replay)
    is_k3 = lambda k: "conv3x3_wgmma_kernel" in k or "splitk_sum" in k
    differ = {k: (ops_e.get(k, 0), ops_r.get(k, 0))
              for k in sorted(ops_e.keys() | ops_r.keys())
              if ops_e.get(k, 0) != ops_r.get(k, 0)}
    use = {k: v - use[k] for k, v in DENOISE_GRAPH_USE.items()}
    out = {"max_abs_diff": diffs, "max_rel_diff": rel,
           "first_call_launches": first, "eager_launches": eager_n,
           "replay_launches": ran, "use": use,
           "capture_peak_bytes": peak,
           "profiler_ops_eager": sum(ops_e.values()),
           "profiler_ops_replay": sum(ops_r.values()),
           "profiler_k3_eager": sum(c for k, c in ops_e.items() if is_k3(k)),
           "profiler_k3_replay": sum(c for k, c in ops_r.items() if is_k3(k)),
           "profiler_ops_differ": {k[:80]: v for k, v in differ.items()},
           **times, "replay_host_us_profiled": round(profiled_us, 1)}
    log("denoise_graph", **out)
    for i, n in enumerate([eager_n, first] + ran):
        if n["K3"] != K3_SITES or n["K3_hopper"] != K3_SITES:
            raise AssertionError(f"denoise_graph: call {i} counted {n}, "
                                 f"want {K3_SITES} K3 (Hopper)")
    if differ or not out["profiler_k3_replay"]:
        raise AssertionError(f"denoise_graph: the profiler's device ops of "
                             f"a replay differ from an eager call's "
                             f"(eager, replay): {differ}")
    # 2 checked replays, cuda_ms's warm-up and reps, reps timed on the
    # host, the profiled one
    if use != {"captures": 1, "replays": 2 * reps + 4, "eager": 0}:
        raise AssertionError(f"denoise_graph: used {use}")
    if not max(rel) <= DENOISE_GRAPH_TOL:
        raise AssertionError(f"denoise_graph: replay vs eager {rel} > "
                             f"{DENOISE_GRAPH_TOL} of the largest |value|")
    return out


def train_phase(tag, gs0, sk, guidance, gen, cam_cfg, rcfg, n_steps: int,
                warmup: int, want: dict):
    """Stage-1 steps at the recipe's sizes from the state gs0: finite
    losses, parameters moved, and the launches in this run alone of each
    kernel that `want` names (`check_launches`).
    Returns (state, config, launches, median ms per step after
    `warmup`)."""
    import torch
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
    from gaussianip_tpu_torch.system import stage1 as s1

    cfg = s1.Stage1Config(render_height=RES, render_width=RES)
    ts = s1.init_train_state(gs0)
    x0 = {f: getattr(gs0, f).clone() for f in PARAM_FIELDS}
    stamps, logs = [], []

    def on_step(i, m):  # metrics arrive as host floats: the step has ended
        stamps.append(time.perf_counter())
        logs.append(m)

    def run():
        stamps.append(time.perf_counter())
        return s1.train_stage1(
            ts, cfg, cam_cfg, rcfg, AdamHyper(), guidance, sk.points3d, gen,
            n_steps=n_steps, log_every=1, log_fn=on_step)

    torch.cuda.reset_peak_memory_stats()
    ts, launches = count_launches(run)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [float(x) for x in np.diff(stamps) * 1e3]
    med = float(np.median(step_ms[warmup:]))
    moved = {f: float((getattr(ts.gaussians, f) - x0[f]).abs().max())
             for f in ("xyz", "f_dc", "opacity", "scaling")}
    losses = [m["loss"] for m in logs]
    sds = [m["loss_sds"] for m in logs]
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(sds))):
        raise AssertionError(f"{tag}: non-finite loss: {losses} {sds}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"{tag}: parameters did not move: {moved}")
    check_launches(tag, launches, want)
    log(tag, steps=n_steps, loss_first=losses[0], loss_last=losses[-1],
        loss_sds=[round(x, 6) for x in sds], median_ms_per_step=med,
        step_ms=[round(x, 3) for x in step_ms], peak_gib=round(peak_gib, 3),
        launches=launches, moved=moved)
    return ts, cfg, launches, med


def flux_phase(gs0, sk, dev="cuda") -> dict:
    """Guided stage-1 steps on the FLUX.1-dev stack at the published widths
    (system/pipeline.py:build_random_flux_guidance: the transformer with
    IP attention, the Union ControlNet, the 16-channel VAE, weights held
    at bf16) at the recipe's sizes through make_train_step, three steps:
    the parameters' bytes by model and dtype, each step's wall ms, the
    second step's launches of each hand-written kernel (`check_launches`:
    the render's K1 and K2; the 22 GroupNorms on K4 and the mid attention
    on K5 in the views' encode, forward and backward, and again in the
    pose maps' encode, forward only; no K3), the third step's spans'
    device ms by name (under torch.profiler, host activity only: the
    spans time the device by their own CUDA events), the peak memory, a
    finite loss and the parameters moved. The stack is freed after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussianip_tpu_torch.data.sampler import CameraSamplerConfig
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.ops import groupnorm_cuda, vae_attention_cuda
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import stage1 as s1
    from gaussianip_tpu_torch.system.pipeline import (
        build_random_flux_guidance)
    from gaussianip_tpu_torch.utils import profiling

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    guidance = build_random_flux_guidance(seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = {}
    for name, m in guidance.models._asdict().items():
        for p in m.parameters():
            k = f"{name}:{str(p.dtype).split('.')[-1]}"
            held[k] = held.get(k, 0) + p.numel() * p.element_size()
    step = s1.make_train_step(
        s1.Stage1Config(render_height=RES, render_width=RES),
        CameraSamplerConfig(height=RES, width=RES, batch_size=BATCH),
        RenderConfig(d_max=D_MAX), AdamHyper(), guidance, sk.points3d)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ts = s1.init_train_state(gs0)
    x0 = ts.gaussians.f_dc.clone()
    ms, losses, by_span = [], [], {}

    def timed():
        nonlocal ts
        t0 = time.perf_counter()
        ts, m = step(ts, gen)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)

    timed()
    _, launches = count_launches(timed)
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        timed()
    for r in profiling.spans():
        by_span.setdefault(r["name"], [0.0, 0])
        by_span[r["name"]][0] += r["device_ms"]
        by_span[r["name"]][1] += 1
    peak = torch.cuda.max_memory_allocated()
    moved = float((ts.gaussians.f_dc - x0).abs().max())
    if not (np.all(np.isfinite(losses)) and moved > 0):
        raise AssertionError(f"flux: losses {losses}, moved {moved}")
    nets = (guidance.models.unet, guidance.models.controlnet)
    want = {"double_block": sum(len(n.double_blocks) for n in nets),
            "single_block": sum(len(n.single_blocks) for n in nets)}
    if {k: by_span.get(k, [0, 0])[1] for k in want} != want:
        raise AssertionError(f"flux: block spans {by_span}, want {want}")
    encodes = 2  # the views' (with backward) and the pose maps'
    check_launches("flux", launches, {
        "K1": 1, "K2": 1, "K3": 0, "K3_hopper": 0, "K3_general": 0,
        "K4_fwd": 22 * groupnorm_cuda.FWD_KERNELS * encodes,
        "K4_bwd": 22 * groupnorm_cuda.BWD_KERNELS,
        "K5_fwd": vae_attention_cuda.fwd_launches(BATCH) * encodes,
        "K5_bwd": vae_attention_cuda.bwd_launches(BATCH)})
    out = {"build_s": round(build_s, 2), "param_bytes": held,
           "step_ms": [round(x, 1) for x in ms], "loss": losses,
           "launches": {k: v for k, v in launches.items() if v},
           "peak_bytes": peak, "peak_gib": round(peak / 2 ** 30, 3),
           "span_ms": {k: round(v[0], 3) for k, v in by_span.items()},
           "span_count": {k: v[1] for k, v in by_span.items()}}
    log("flux", **out)
    del guidance, step, ts
    torch.cuda.empty_cache()
    return out


def check_launches(tag, got, want):
    """Raise unless each kernel that `want` names (the registry's names)
    launched as often in `got`; the others are not checked."""
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")


def check_images(tag, x, shape):
    """x: finite, in [0, 1], of `shape`."""
    import torch

    if tuple(x.shape) != tuple(shape):
        raise AssertionError(f"{tag}: shape {tuple(x.shape)} != {shape}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{tag}: non-finite values")
    lo, hi = float(x.min()), float(x.max())
    if not (lo >= 0.0 and hi <= 1.0):
        raise AssertionError(f"{tag}: values in [{lo}, {hi}]")


def handoff(ts, sk, rcfg):
    """The stage-1 -> stage-2 handoff: the state through state_to_ply and
    state_from_ply (every field equal), then the 32 refine views at 1024^2
    in sweeps of 4 (K1 only) and their pose maps."""
    import tempfile

    import torch
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
    from gaussianip_tpu_torch.model.ply import state_from_ply, state_to_ply
    from gaussianip_tpu_torch.system.refine import render_refine_views

    g = ts.gaussians
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stage1.ply")
        state_to_ply(g, path)
        ply_bytes = os.path.getsize(path)
        g2 = state_from_ply(path, capacity=g.capacity, device="cuda")
    ply_s = time.perf_counter() - t0
    same = {f: bool(torch.equal(getattr(g2, f), getattr(g, f)))
            for f in PARAM_FIELDS}
    if not (all(same.values()) and g2.n_active == g.n_active
            and g2.max_sh_degree == g.max_sh_degree):
        raise AssertionError(f"handoff: the .ply round trip changed the "
                             f"state: {same}, n_active {g2.n_active} vs "
                             f"{g.n_active}")
    orbit = refine_orbit_batch(REFINE_VIEWS, 17.0, 1.5, 70.0, HIRES, HIRES,
                               device="cuda")
    t0 = time.perf_counter()
    (images, poses), launches = count_launches(lambda: render_refine_views(
        g2, orbit, sk.points3d, HIRES, HIRES, rcfg))
    render_s = time.perf_counter() - t0
    shape = (REFINE_VIEWS, HIRES, HIRES, 3)
    check_images("handoff images", images, shape)
    check_images("handoff pose maps", poses, shape)
    want = {"K1": REFINE_VIEWS // 4, "K2": 0, "K3": 0,
            "K3_hopper": 0, "K3_general": 0}
    check_launches("handoff", launches, want)
    covered = (images.amax(dim=-1) > 0).flatten(1).float().mean(1)
    if not bool((covered > 0).all()):
        raise AssertionError(f"handoff: empty views {covered.tolist()}")
    log("handoff", n_active=g2.n_active, ply_bytes=ply_bytes,
        ply_round_trip_s=round(ply_s, 3), views=REFINE_VIEWS,
        render_and_pose_s=round(render_s, 3),
        covered_share=spread(covered), launches=launches)
    return g2, orbit, images, poses, launches


def refine_call_inputs(models, contexts, images, poses, gen):
    """One anchors call of the refine (store mode, 4 views, CFG batch 8)
    on random latents: (latents, context, pose maps)."""
    import torch
    from gaussianip_tpu_torch.system.refine import ANCHOR_NAMES, view_index

    idx = torch.tensor([view_index(n) for n in ANCHOR_NAMES], device="cuda")
    s = images.shape[1] // models.vae.cfg.downscale
    lat = torch.randn((len(idx), 4, s, s), generator=gen, device="cuda")
    ctx = torch.cat([torch.stack([contexts[n][k] for n in ANCHOR_NAMES])
                     for k in (0, 1)])
    return lat, ctx, poses[idx].permute(0, 3, 1, 2)


def check_sdpa():
    """The largest attention of the refine: the level-0 self-attention of a
    key-mode call at 1024^2, 8 CFG rows x 16384 queries over cat(self,
    source) = 32768 keys, 8 heads of 40, bf16. Timed as the UNet calls it
    and with only the fused backends (flash, memory-efficient) allowed,
    which raises if neither takes it; peak memory beside each (the math
    backend's scores alone would be 68.7 GB)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from gaussianip_tpu_torch.diffusion.blocks import attend

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((8, 16384, 320), generator=g, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((8, 32768, 320), generator=g, device="cuda").to(
        torch.bfloat16)
    out = {}
    for name, ctx in (("fused_only", lambda: sdpa_kernel(
            [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])),
                      ("as_called", lambda: torch.no_grad())):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ctx():
            out[f"{name}_ms"] = cuda_ms(lambda: attend(q, kv, kv, 8), 5, 1)
        out[f"{name}_peak_gib"] = round(
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30, 3)
    flop = 4.0 * 8 * 16384 * 32768 * 320
    log("sdpa:key", shape="8x16384x320 over 32768 keys, 8 heads",
        tflop=flop / 1e12, **{k: round(v, 4) for k, v in out.items()},
        tflops=round(flop / out["as_called_ms"] / 1e9, 1))


def check_refine_reference(r: int = REFINE_REF_RES) -> float:
    """The tiny stack's refine_views (1 step, 32 views at r^2: the VAE,
    anchors, keys and 6 dense groups, every stride-1 conv through K3) at
    bf16 on the card against the same weights at float32 on the CPU.
    Returns the worst |diff|."""
    import torch
    from gaussianip_tpu_torch.guidance.prompts import fake_text_encoder
    from gaussianip_tpu_torch.system.pipeline import (
        build_stub_guidance_stack, refine_models)
    from gaussianip_tpu_torch.system.refine import (refine_contexts,
                                                    refine_views)

    args = ("a person", "bad quality", r, SEED)
    ref = build_stub_guidance_stack(*args, device="cpu")
    card = build_stub_guidance_stack(*args, device="cuda", dtype=torch.bfloat16)
    for a, b in zip(card.models, ref.models):
        a.load_state_dict(b.state_dict())
    g = torch.Generator().manual_seed(SEED)
    imgs = torch.rand((REFINE_VIEWS, r, r, 3), generator=g)
    poses = torch.rand((REFINE_VIEWS, r, r, 3), generator=g)
    noise = torch.randn((4, r // 2, r // 2), generator=g)
    ctx = refine_contexts(fake_text_encoder(77, 32), "a person",
                          torch.full((4, 32), 0.01), torch.zeros((4, 32)),
                          device="cpu")
    outs, launches = [], None
    for guid, d in ((ref, "cpu"), (card, "cuda")):
        run = lambda: refine_views(
            refine_models(guid), imgs.to(d), poses.to(d),
            {k: v.to(d) for k, v in ctx.items()}, noise.to(d), num_steps=1)
        out, launches = count_launches(run)
        outs.append(out.float().cpu())
    if launches["K3"] == 0 or launches["K3_general"] == 0:
        raise AssertionError(f"refine_reference: the card's tiny stack did "
                             f"not run K3's general variant: {launches}")
    err = float((outs[1] - outs[0]).abs().max())
    interior = float(((outs[0] > 0) & (outs[0] < 1)).float().mean())
    if not err <= REFINE_REF_TOL:
        raise AssertionError(f"refine_reference: card bf16 vs CPU f32 "
                             f"{err} > {REFINE_REF_TOL}")
    if not interior > REFINE_REF_INTERIOR:
        raise AssertionError(f"refine_reference: only {interior} of the "
                             f"pixels inside (0, 1): the clamp decides")
    log("refine_reference", views=REFINE_VIEWS, res=r, max_abs_err=err,
        mean_abs_err=float((outs[1] - outs[0]).abs().mean()),
        tol=REFINE_REF_TOL, interior_share=round(interior, 4),
        interior_floor=REFINE_REF_INTERIOR,
        launches=launches)
    return err


def vae_hires(vae, images):
    """The VAE at 1024^2 on one chunk of 2 views: encode and decode ms
    (CUDA events) and the peak memory above what was allocated before."""
    import torch
    from gaussianip_tpu_torch.system.refine import vae_decode, vae_encode

    x = images[:2]
    lat = vae_encode(vae, x)
    out = {}
    for name, fn in (("encode", lambda: vae_encode(vae, x)),
                     ("decode", lambda: vae_decode(vae, lat))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[f"{name}_ms"] = round(cuda_ms(fn, 2, 1), 3)
        out[f"{name}_peak_gib"] = round(
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30, 3)
    log("stage2:vae", images=2, res=x.shape[1], **out)
    return out


def stage2_phase(models, images, poses, contexts, gen):
    """Full refine_views at 1024^2: 32 views, REFINE_STEPS steps. Wall
    time, CUDA-event ms of each denoise call by phase and of the VAE encode
    and decode, peak memory and each kernel's launches; the views are
    finite, in [0, 1], of the input's shape and each changed from its
    input. Returns (refined views, the stage-3 targets, launches)."""
    import torch
    from gaussianip_tpu_torch.system.refine import (CROP_X, CROP_Y,
                                                    crop_and_downsample,
                                                    refine_views)

    s = images.shape[1] // models.vae.cfg.downscale
    noise = torch.randn((4, s, s), generator=gen, device="cuda")
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    refined, launches = count_launches(lambda: refine_views(
        models, images, poses, contexts, noise, num_steps=REFINE_STEPS,
        on_phase=on_phase))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_phase, prev = {}, start
    for name, ev in marks:
        by_phase.setdefault(name, []).append(prev.elapsed_time(ev))
        prev = ev
    check_images("stage2_refine", refined, images.shape)
    changed = (refined - images).abs().flatten(1).mean(1)
    if not bool((changed > 1e-3).all()):
        raise AssertionError(f"stage2_refine: views unchanged: "
                             f"{changed.tolist()}")
    calls = REFINE_STEPS * REFINE_CALLS_PER_STEP
    want = {"K1": 0, "K2": 0, "K3": K3_SITES * calls,
            "K3_hopper": K3_SITES * calls, "K3_general": 0}
    check_launches("stage2_refine", launches, want)
    targets = crop_and_downsample(refined)
    check_images("stage3 targets", targets, (
        REFINE_VIEWS, (CROP_Y[1] - CROP_Y[0]) // 2,
        (CROP_X[1] - CROP_X[0]) // 2, 3))
    ms = {k: [round(x, 3) for x in v] for k, v in by_phase.items()}
    mean = {k: round(float(np.mean(v)), 3) for k, v in by_phase.items()}
    log("stage2_refine", views=REFINE_VIEWS, res=HIRES, steps=REFINE_STEPS,
        denoise_calls=calls, wall_s=round(wall_s, 3),
        ms_mean_by_phase=mean,
        denoise_ms_total=round(sum(sum(by_phase[k]) for k in (
            "anchors", "keys", "dense")), 3),
        vae_encode_s=round(ms["encode"][0] / 1e3, 4),
        vae_decode_s=round(ms["decode"][0] / 1e3, 4),
        peak_gib=round(peak, 3), launches=launches,
        change_mean_abs=spread(changed), targets=list(targets.shape))
    log("stage2_refine:calls", **{k: v for k, v in ms.items()
                                  if k not in ("encode", "decode")})
    return refined, targets, launches


def stage3_phase(gs, orbit, targets, gen):
    """Stage-3 steps at the recipe's sizes (4 views at 1024^2, crop and
    halve, 10 L1 + 15 LPIPS at VGG16 width with random weights) from the
    handoff's state, with the densify after step index 100. Step times,
    profiled device time and busy share, peak memory, losses, n_active
    around the densify, launches; every parameter finite, and the L1 over
    all 32 views lower after the steps than before. Returns (state,
    launches, median ms per step)."""
    import torch
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
    from gaussianip_tpu_torch.ops.resize import linear_resize
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.pipeline import build_random_lpips
    from gaussianip_tpu_torch.system.stage1 import init_train_state
    from gaussianip_tpu_torch.system.stage3 import (Stage3Config,
                                                    draw_view_ids,
                                                    make_stage3_step,
                                                    render_turntable,
                                                    train_stage3)

    cfg = Stage3Config()  # the recipe's: 1024^2, crop [60:890, 220:800]
    rcfg = RenderConfig(d_max=S3_D_MAX)
    lpips = build_random_lpips(SEED, "cuda")
    ts = init_train_state(gs)
    ids = draw_view_ids(gen, REFINE_VIEWS, cfg.train_bs, S3_STEPS, "cuda")
    noise = torch.randn((2, gs.capacity, 3), generator=gen, device="cuda")
    stamps, logs = [], []

    def on_step(i, m):  # metrics arrive as host floats: the step has ended
        stamps.append(time.perf_counter())
        logs.append(m)

    def views_l1(g):
        """The step's L1 over every refine view (renders in sweeps of 4)."""
        with torch.no_grad():
            rgb = render_turntable(g, orbit, cfg.height, cfg.width, rcfg)
            crop = rgb[:, cfg.crop_y[0]:cfg.crop_y[1],
                       cfg.crop_x[0]:cfg.crop_x[1]].permute(0, 3, 1, 2)
            small = linear_resize(crop, targets.shape[1], targets.shape[2])
            return float((small.permute(0, 2, 3, 1) - targets).abs().mean())

    l1_start = views_l1(gs)
    def run():
        stamps.append(time.perf_counter())
        return train_stage3(ts, cfg, rcfg, AdamHyper(), orbit, targets, ids,
                            noise, lpips_fn=lpips, log_every=1,
                            log_fn=on_step)

    torch.cuda.reset_peak_memory_stats()
    ts, launches = count_launches(run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"K1": S3_STEPS, "K2": S3_STEPS, "K3": 0,
            "K3_hopper": 0, "K3_general": 0}
    check_launches("stage3", launches, want)
    for f in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(ts.gaussians, f)).all()):
            raise AssertionError(f"stage3: non-finite {f}")
    step_ms = [float(x) for x in np.diff(stamps) * 1e3]
    med = float(np.median(step_ms[S3_WARMUP:]))
    k = cfg.densify_step
    n_before, n_after = logs[k]["n_active"], logs[k + 1]["n_active"]
    if n_after == n_before:
        raise AssertionError(f"stage3: n_active {n_before} unchanged by the "
                             f"densify after step {k}")
    l1_end = views_l1(ts.gaussians)
    if not l1_end < l1_start:
        raise AssertionError(f"stage3: L1 over the {REFINE_VIEWS} views did "
                             f"not fall: {l1_start} -> {l1_end}")
    step_fn = make_stage3_step(cfg, rcfg, AdamHyper(), orbit, targets,
                               lpips)
    state = [ts]

    def step():
        state[0], _ = step_fn(state[0], ids[0])

    dev_ms, busy = profile_window(step, 3, "profile_stage3")
    log("stage3", steps=S3_STEPS, res=HIRES, views=cfg.train_bs,
        median_ms_per_step=med, device_ms_per_step=round(dev_ms, 3),
        device_busy_share=round(busy, 4), peak_gib=round(peak, 3),
        loss_first=logs[0]["loss"], loss_last=logs[-1]["loss"],
        lpips_first=logs[0]["lpips"], lpips_last=logs[-1]["lpips"],
        l1_all_views_start=l1_start, l1_all_views_end=l1_end,
        l1_steps_first10=float(np.mean([m["l1"] for m in logs[:10]])),
        l1_steps_last10=float(np.mean([m["l1"] for m in logs[-10:]])),
        densify_after_step=k, n_active_before=n_before,
        n_active_after=n_after, launches=launches,
        step_ms=[round(x, 2) for x in step_ms])
    return ts, launches, med


def turntable_phase(gs):
    """The final avatar's turntable: eval_orbit_batch(..., "test") of the
    recipe (144 body and 144 head views) at 1024^2 in sweeps of 4 (K1
    only); total ms, frames finite and in [0, 1]."""
    import torch
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   eval_orbit_batch)
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.stage3 import render_turntable

    orbit = eval_orbit_batch(CameraSamplerConfig(eval_height=HIRES,
                                                 eval_width=HIRES),
                             "test", device="cuda")
    n = orbit.c2w.shape[0]
    t0 = time.perf_counter()
    frames, launches = count_launches(lambda: render_turntable(
        gs, orbit, HIRES, HIRES, RenderConfig(d_max=S3_D_MAX)))
    total_ms = (time.perf_counter() - t0) * 1e3
    check_images("turntable", frames, (n, HIRES, HIRES, 3))
    want = {"K1": -(-n // 4), "K2": 0, "K3": 0, "K3_hopper": 0,
            "K3_general": 0}
    check_launches("turntable", launches, want)
    log("turntable", frames=n, res=HIRES, total_ms=round(total_ms, 3),
        ms_per_frame=round(total_ms / n, 3), launches=launches)
    return launches


def anim_motion() -> np.ndarray:
    """The seeded random motion, [ANIM_MOTION, 55, 3] axis-angle."""
    rng = np.random.default_rng(SEED)
    return rng.normal(0, 0.05, (ANIM_MOTION, 55, 3)).astype(np.float32)


def animation_phase(gs, tmp: str, dev="cuda"):
    """The animation command line in-process, as a user runs it
    (`python -m gaussianip_tpu_torch.animation --stub-body --play --rotate
    --W 1024 --H 1024 --max_frames ANIM_FRAMES`), on the final avatar's
    .ply and the seeded motion written into `tmp`: the culled count, the
    bind's seconds, the ms per frame (re-pose + render + host copy,
    between consecutive frames' starts), the writer, the peak memory
    above what was held, a profile of 3 more frames; K1 launched once a
    frame and K2 never; every frame finite and in [0, 1];
    some alpha coverage; the file written. Returns a dict with the
    launches, the animator after its last frame, that frame's azimuth,
    the .ply and the motion."""
    import torch
    from gaussianip_tpu_torch import animation
    from gaussianip_tpu_torch.human import animation as am
    from gaussianip_tpu_torch.model.ply import state_to_ply
    from gaussianip_tpu_torch.utils import saving

    ply = os.path.join(tmp, "avatar.ply")
    state_to_ply(gs, ply)
    motion = anim_motion()
    mpath = os.path.join(tmp, "walk.npz")
    np.savez(mpath, poses=motion)
    seen = {"stamps": [], "frames": [], "coverage": []}

    def bind(fn):
        def run(self, *a, **kw):
            seen["animator"] = self
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seen["culled"] = fn(self, *a, **kw)
            torch.cuda.synchronize()
            seen["bind_s"] = time.perf_counter() - t0
            return seen["culled"]
        return run

    def repose(fn):
        def run(self, frame):
            seen["stamps"].append(time.perf_counter())
            return fn(self, frame)
        return run

    def render_frame(fn):
        def run(*a, **kw):
            img = fn(*a, **kw)
            seen["frames"].append(torch.stack([
                torch.isfinite(img).all().float(), img.amin(), img.amax()]))
            return img
        return run

    def render(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen["coverage"].append((out.alpha > 0).float().mean())
            return out
        return run

    def save_video(fn):
        def run(*a, **kw):
            seen["stamps"].append(time.perf_counter())
            seen["written"] = fn(*a, **kw)
            return seen["written"]
        return run

    argv = ["--ply", ply, "--motion", mpath, "--stub-body", "--play",
            "--rotate", "--W", str(HIRES), "--H", str(HIRES), "--max_frames",
            str(ANIM_FRAMES), "--save", tmp, "--device", dev]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with patched((am.AvatarAnimator, "bind", bind),
                 (am.AvatarAnimator, "repose", repose),
                 (am.AvatarAnimator, "render_frame", render_frame),
                 (am, "render", render), (saving, "save_video", save_video)):
        out, launches = count_launches(lambda: animation.main(argv))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    frames = len(seen["frames"])
    want = {"K1": ANIM_FRAMES, "K2": 0, "K3": 0, "K3_hopper": 0,
            "K3_general": 0}
    if frames != ANIM_FRAMES:
        raise AssertionError(f"animation: {frames} frames")
    check_launches("animation", launches, want)
    stats = torch.stack(seen["frames"]).cpu().numpy()
    if not (stats[:, 0].all() and stats[:, 1].min() >= 0.0
            and stats[:, 2].max() <= 1.0):
        raise AssertionError(f"animation: frames not finite in [0, 1]: "
                             f"min {stats[:, 1].min()} max "
                             f"{stats[:, 2].max()}")
    coverage = torch.stack(seen["coverage"])
    if not float(coverage.max()) > 0:
        raise AssertionError("animation: no frame has alpha coverage")
    written = seen["written"]
    if not (written in (out, out + ".npy") and os.path.exists(written)
            and os.path.getsize(written) > 0):
        raise AssertionError(f"animation: {out} not written ({written})")
    frame_ms = np.diff(seen["stamps"]) * 1e3
    loaded = gs.n_active
    log("animation", loaded=loaded, culled=seen["culled"],
        culled_share=round(seen["culled"] / loaded, 6),
        bind_s=round(seen["bind_s"], 4), frames=frames, res=HIRES,
        median_ms_per_frame=round(float(np.median(frame_ms)), 3),
        first_frame_ms=round(float(frame_ms[0]), 3),
        writer="mp4" if written.endswith(".mp4") else "npy",
        bytes=os.path.getsize(written), peak_above_start_gib=round(peak, 3),
        coverage=spread(coverage), launches=launches)
    animator, frame = seen["animator"], iter(range(ANIM_FRAMES, 10 ** 6))

    def one_frame():  # as render_motion runs a frame
        i = next(frame)
        animator.repose(i % animator.n_frames)
        img = animator.render_frame(float(i % 360), height=HIRES,
                                    width=HIRES)
        return (img * 255).to(torch.uint8).cpu()

    profile_window(one_frame, 3, "profile_animation")
    return {"launches": launches, "animator": animator,
            "azimuth": float((frames - 1) % 360), "ply": ply,
            "motion": motion}


def bind_full_phase(ply: str, motion, dev="cuda"):
    """signed_distance_to_mesh at the SMPL-X sizes: the loaded avatar's
    points against the frame-0 mesh of a synthetic body with 10,475
    vertices and 20,908 faces, as AvatarAnimator.bind calls it; seconds,
    peak memory above what was held, blocks. Held against a dense evaluation over every face
    on a strided sample: |d| and the closest point within BIND_TOL."""
    import inspect

    import torch
    from gaussianip_tpu_torch.human.animation import (AvatarAnimator,
                                                      load_animation_ply)
    from gaussianip_tpu_torch.human.smplx import make_test_model
    from gaussianip_tpu_torch.ops.triangle import (closest_point_barycentric,
                                                   signed_distance_to_mesh)

    params = make_test_model(np.random.default_rng(0), *SMPLX_SIZES,
                             device=dev)
    anim = AvatarAnimator(load_animation_ply(ply, device=dev), params,
                          motion_poses=motion)
    verts, faces = anim._mesh_at(0), anim.faces
    pts = anim.gaussians.xyz[:anim.gaussians.n_active]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d, fi, uvw = signed_distance_to_mesh(pts, verts, faces)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    blocks = {k: v.default for k, v in inspect.signature(
        signed_distance_to_mesh).parameters.items() if k.endswith("block")}

    def closest(f, w):
        fa = faces[f]
        return (w[:, 0:1] * verts[fa[:, 0]] + w[:, 1:2] * verts[fa[:, 1]]
                + w[:, 2:3] * verts[fa[:, 2]])

    idx = torch.arange(0, pts.shape[0], max(1, pts.shape[0] // BIND_SAMPLE),
                       device=dev)
    a, b, c = (verts[faces[:, i]][None] for i in range(3))
    d_ref, cp_ref = [], []
    with torch.no_grad():
        for s in range(0, idx.numel(), 128):
            p = pts[idx[s:s + 128]][:, None]
            w = closest_point_barycentric(p, a, b, c)  # [128, F, 3]
            cp = w[..., 0:1] * a + w[..., 1:2] * b + w[..., 2:3] * c
            d2 = ((p - cp) ** 2).sum(-1)
            best = d2.argmin(dim=1)
            d_ref.append(d2.gather(1, best[:, None])[:, 0].sqrt())
            cp_ref.append(cp[torch.arange(best.numel(), device=dev), best])
    d_err = float((d[idx].abs() - torch.cat(d_ref)).abs().max())
    cp_err = float((closest(fi[idx], uvw[idx]) - torch.cat(cp_ref)).abs()
                   .max())
    if not (d_err < BIND_TOL and cp_err < BIND_TOL):
        raise AssertionError(f"animation:bind_full: |d| err {d_err}, closest "
                             f"point err {cp_err} vs {BIND_TOL}")
    log("animation:bind_full", points=pts.shape[0], verts=SMPLX_SIZES[0],
        faces=SMPLX_SIZES[1], seconds=round(secs, 4),
        peak_above_start_gib=round(peak, 3), **blocks, sample=idx.numel(),
        d_max_abs_err=d_err, closest_max_abs_err=cp_err)


def anim_refine_phase(guidance, motion, gen, dev="cuda"):
    """Animation-space refine steps at the stage-1 recipe's shapes:
    PTS_NUM canonical points on the A-pose surface of the SMPL-X-size
    synthetic body in a capacity-CAPACITY state, 4 views at 512^2, K = 6,
    `guidance` (the SD1.5-width random stack), the seeded motion; per step
    one K1, one K2 and K3_SITES K3 launches, finite losses, and a nonzero
    Adam moment on the canonical xyz; the k-NN's and the blend's ms at the
    step's shapes, and a profile of 2 more steps. Returns (launches,
    median ms per step after AR_WARMUP)."""
    import torch
    from gaussianip_tpu_torch.data.sampler import CameraSamplerConfig
    from gaussianip_tpu_torch.human.animation import load_motion
    from gaussianip_tpu_torch.human.lbs_deform import (
        LBSDeformer, a2pose_transforms, lbs_diffuse_transforms)
    from gaussianip_tpu_torch.human.skeleton import (apose_body_pose,
                                                     sample_surface_points)
    from gaussianip_tpu_torch.human.smplx import make_test_model
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.ops.knn import knn_dist2, mean_dist2_3nn
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.anim_refine import (
        AnimRefineConfig, make_anim_refine_step)
    from gaussianip_tpu_torch.system.stage1 import init_train_state

    params = make_test_model(np.random.default_rng(0), *SMPLX_SIZES,
                             device=dev)
    deformer = LBSDeformer(params, canonical_body_pose=torch.as_tensor(
        apose_body_pose(), device=dev))
    a_verts = deformer.a_verts
    canonical = {"a_verts": a_verts, "inv_T_t2a": deformer.inv_T_t2a,
                 "canonical_offsets": deformer.canonical_offsets}
    pts = sample_surface_points(a_verts.cpu().numpy(), params.faces,
                                PTS_NUM, SEED)
    d2 = mean_dist2_3nn(torch.as_tensor(pts, device=dev))
    gs = create_from_pcd(pts, np.full((PTS_NUM, 3), 0.5, np.float32),
                         CAPACITY, d2, device=dev)
    ts = init_train_state(gs)
    step = make_anim_refine_step(
        AnimRefineConfig(render_height=RES, render_width=RES),
        CameraSamplerConfig(height=RES, width=RES, batch_size=BATCH),
        RenderConfig(d_max=D_MAX), AdamHyper(), guidance, params,
        load_motion(motion_poses=motion), canonical)
    stamps, losses = [], []
    n_steps = AR_WARMUP + AR_STEPS

    def run():
        state = ts
        stamps.append(time.perf_counter())
        for _ in range(n_steps):
            state, m = step(state, gen)
            losses.append(float(m["loss"]))  # the step has ended
            stamps.append(time.perf_counter())
        return state

    torch.cuda.reset_peak_memory_stats()
    use0 = dict(DENOISE_GRAPH_USE)
    ts, launches = count_launches(run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"K1": n_steps, "K2": n_steps, "K3": K3_SITES * n_steps,
            "K3_hopper": K3_SITES * n_steps, "K3_general": 0}
    check_launches("anim_refine", launches, want)
    # 64^2 latents: the denoise replays from its CUDA graph (a signature
    # that stage 1 did not capture is captured once here)
    use = {k: v - use0[k] for k, v in DENOISE_GRAPH_USE.items()}
    log("denoise_graph_use", path="anim_refine", **use)
    if use["eager"] or use["captures"] > 1 \
            or use["captures"] + use["replays"] != n_steps:
        raise AssertionError(f"anim_refine: the denoise graph's use {use}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"anim_refine: non-finite loss {losses}")
    m_xyz = float(ts.opt.m["xyz"][:PTS_NUM].abs().max())
    if not m_xyz > 0:
        raise AssertionError("anim_refine: no Adam moment on canonical xyz")
    step_ms = np.diff(stamps) * 1e3
    med = float(np.median(step_ms[AR_WARMUP:]))
    # the deformation's layers at the step's shapes: the k-NN search, and
    # the blended transforms with it (forward, no autograd)
    xyz = ts.gaussians.xyz
    with torch.no_grad():
        knn_ms = cuda_ms(lambda: knn_dist2(xyz, a_verts, k=6), 5, 1)
        T_a2pose = a2pose_transforms(params, deformer.inv_T_t2a,
                                     deformer.canonical_offsets)
        lbs_ms = cuda_ms(lambda: lbs_diffuse_transforms(
            params.lbs_weights, T_a2pose, xyz, a_verts), 5, 1)
    log("anim_refine", points=PTS_NUM, capacity=CAPACITY, views=BATCH,
        res=RES, k=6, steps=n_steps, median_ms_per_step=round(med, 3),
        step_ms=[round(float(x), 3) for x in step_ms],
        knn_ms=round(knn_ms, 3), lbs_transforms_ms=round(lbs_ms, 3),
        peak_gib=round(peak, 3), losses=[round(x, 6) for x in losses],
        xyz_adam_m_max=m_xyz, launches=launches)
    state = [ts]

    def one_step():
        state[0], _ = step(state[0], gen)

    profile_window(one_step, 2, "profile_anim_refine")
    return launches, med


def blender_cameras(split: str, dev="cuda"):
    """(c2w [V, 4, 4] look-at matrices, fovy [V]) of the photo scene's
    split: train on the upper hemisphere (seeded), test on a circle at
    elevation 30 degrees; all at PR_RADIUS looking at the origin, z up."""
    import torch
    from gaussianip_tpu_torch.ops.camera_math import look_at_c2w

    if split == "train":
        d = np.random.default_rng(SEED).normal(size=(PR_TRAIN_VIEWS, 3))
        d[:, 2] = np.abs(d[:, 2])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        el = np.deg2rad(30.0)
        az = np.linspace(0, 2 * np.pi, PR_TEST_VIEWS, endpoint=False)
        d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                      np.full_like(az, np.sin(el))], -1)
    f32 = dict(dtype=torch.float32, device=dev)
    v = d.shape[0]
    c2w = look_at_c2w(torch.as_tensor(d * PR_RADIUS, **f32),
                      torch.zeros((v, 3), **f32),
                      torch.tensor([[0.0, 0, 1]], **f32).expand(v, 3))
    return c2w, torch.full((v,), PR_FOVX, **f32)


def write_blender_scene(gs, root: str, res: int, dev="cuda"):
    """A NeRF-synthetic-layout scene of `gs` in `root`:
    transforms_{train,test}.json (camera_angle_x, a transform_matrix per
    frame) and {split}/r_{i}.png frames rendered by the port at res^2 on a
    black background (RenderConfig(), sweeps of 4). Both packages' Blender
    reader flips the y and z columns of every matrix, as if the renderer
    took COLMAP's convention; the renderer takes the look-at (OpenGL)
    one. So the file holds the look-at matrices with y and z flipped, which
    the reader turns back into the cameras the frames were rendered from.
    Returns the seconds of the renders and of the PNG writes."""
    import torch
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.render.render import RenderConfig, render
    from gaussianip_tpu_torch.utils.saving import save_image

    t_render = t_write = 0.0
    for split in ("train", "test"):
        c2w, fovy = blender_cameras(split, dev)
        frames = []
        for s in range(0, c2w.shape[0], 4):
            t0 = time.perf_counter()
            with torch.no_grad():
                rgb = render(gs, camera_from_c2w(c2w[s:s + 4], fovy[s:s + 4],
                                                 res, res),
                             torch.zeros(3, device=dev), RenderConfig()).rgb
            rgb = rgb.cpu().numpy()
            t1 = time.perf_counter()
            for j, img in enumerate(rgb):
                name = f"{split}/r_{s + j}"
                save_image(os.path.join(root, name + ".png"), img)
                m = c2w[s + j].cpu().numpy().astype(np.float64)
                m[:3, 1:3] *= -1
                frames.append({"file_path": "./" + name,
                               "transform_matrix": m.tolist()})
            t_render += t1 - t0
            t_write += time.perf_counter() - t1
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": PR_FOVX, "frames": frames}, f)
    return t_render, t_write


def photo_recon_phase(gs, tmp: str, gen, dev="cuda"):
    """Photo reconstruction of the avatar's Blender-layout scene, as a user
    runs it: load_scene, the images, train_photo_recon with
    PhotoReconConfig()'s defaults cut to PR_ITERS iterations, PR_SH_STEPS
    steps of make_recon_step at SH degree 3, evaluate on the test views
    before and after (PSNR, SSIM, LPIPS with build_random_lpips(seed=42)),
    reset_opacity once. The median step after PR_WARMUP, n_active, the
    first and last loss, the wall seconds; K1 once a step and an evaluated
    view, K2 once a step; the PSNR up by PR_MIN_GAIN_DB and the loss down.
    Returns a dict with the launches, the trained state and one test
    camera."""
    import dataclasses

    import torch
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.scene_readers import (load_blender_scene,
                                                         load_scene)
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.densify import reset_opacity
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import photo_recon as pr
    from gaussianip_tpu_torch.system.pipeline import build_random_lpips

    root = os.path.join(tmp, "photo_scene")
    cfg = dataclasses.replace(pr.PhotoReconConfig(), iterations=PR_ITERS)
    t_render, t_write = write_blender_scene(gs, root, cfg.resolution, dev)
    lpips = build_random_lpips(seed=42, device=dev)
    stamps, losses = [], []

    def log_fn(i, m):  # log_every=1: the metrics are host floats
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    def run():
        t0 = time.perf_counter()
        scene = load_scene(root)
        test = load_blender_scene(root, split="test")
        images = pr._load_images(scene, cfg.resolution)
        test_images = pr._load_images(test, cfg.resolution)
        out = {"load_s": time.perf_counter() - t0}
        init = pr.init_from_scene(scene, cfg, SEED, dev)
        out["n_init"] = init.gaussians.n_active
        out["before"] = pr.evaluate(init, test, cfg, images=test_images,
                                    lpips_fn=lpips)
        del init
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ts = pr.train_photo_recon(scene, cfg, seed=SEED, images=images,
                                  log_every=1, log_fn=log_fn, device=dev)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["n_trained"] = ts.gaussians.n_active
        c2ws, fovys = pr.scene_tensors(scene, dev)
        step = pr.make_recon_step(
            cfg, RenderConfig(),
            AdamHyper(spatial_lr_scale=scene.nerf_normalization_radius),
            c2ws, fovys, torch.as_tensor(images, device=dev), cfg.sh_degree)
        sh_losses = []
        for _ in range(PR_SH_STEPS):
            ts, m = step(ts, gen)
            sh_losses.append(float(m["loss"]))
        out["sh_losses"] = sh_losses
        out["after"] = pr.evaluate(ts, test, cfg, images=test_images,
                                   lpips_fn=lpips)
        g, opt = reset_opacity(ts.gaussians, ts.opt)
        out["reset_max_opacity"] = float(
            g.get_opacity()[:g.n_active].max())
        out["reset_moments"] = float(opt.m["opacity"].abs().max()
                                     + opt.v["opacity"].abs().max())
        out["state"], out["test"], out["step"] = ts, test, step
        return out

    out, launches = count_launches(run)
    n_eval = 2 * PR_TEST_VIEWS
    n_steps = PR_ITERS + PR_SH_STEPS
    want = {"K1": n_steps + n_eval, "K2": n_steps, "K3": 0,
            "K3_hopper": 0, "K3_general": 0}
    check_launches("photo_recon", launches, want)
    before, after = out["before"], out["after"]
    gain = after["psnr"] - before["psnr"]
    step_ms = np.diff(stamps) * 1e3
    log("photo_recon", train_views=PR_TRAIN_VIEWS, test_views=PR_TEST_VIEWS,
        res=cfg.resolution, iterations=PR_ITERS, sh_steps=PR_SH_STEPS,
        scene_render_s=round(t_render, 3), scene_write_s=round(t_write, 3),
        load_s=round(out["load_s"], 3), train_wall_s=round(out["train_s"], 3),
        median_step_ms=round(float(np.median(step_ms[PR_WARMUP:])), 3),
        p90_step_ms=round(float(np.quantile(step_ms[PR_WARMUP:], 0.9)), 3),
        n_active_before=out["n_init"], n_active_after=out["n_trained"],
        loss_first=round(losses[0], 6), loss_last=round(losses[-1], 6),
        sh3_losses=[round(x, 6) for x in out["sh_losses"]],
        peak_gib=round(out["peak_gib"], 3), eval_before=before,
        eval_after=after, psnr_gain_db=round(gain, 3),
        reset_max_opacity=out["reset_max_opacity"], launches=launches)
    if not (gain >= PR_MIN_GAIN_DB and losses[-1] < losses[0]
            and np.all(np.isfinite(losses + out["sh_losses"]))):
        raise AssertionError(f"photo_recon: PSNR {before['psnr']} -> "
                             f"{after['psnr']} (need +{PR_MIN_GAIN_DB}), "
                             f"loss {losses[0]} -> {losses[-1]}")
    if not (out["reset_max_opacity"] <= 0.01 + 1e-6
            and out["reset_moments"] == 0.0):
        raise AssertionError(f"photo_recon: reset_opacity left opacity "
                             f"{out['reset_max_opacity']}, moments "
                             f"{out['reset_moments']}")
    ts, step = out["state"], out["step"]
    state = [ts]

    def one_step():  # at SH degree 3
        state[0], _ = step(state[0], gen)

    profile_window(one_step, 3, "profile_photo_recon")
    c2w, fovy = pr.scene_tensors(out["test"], dev)
    return {"launches": launches,
            "gaussians": ts.gaussians.replace(active_sh_degree=cfg.sh_degree),
            "cams": camera_from_c2w(c2w[:1], fovy[:1], cfg.resolution,
                                    cfg.resolution)}


def export_phase(gs, tmp: str, dev="cuda"):
    """`python -m gaussianip_tpu_torch.launch --config configs/exp.yaml
    --export --resume_from <the avatar's .ply>` in-process at the
    exporter's settings: the seconds of the density splat, marching
    tetrahedra, the colour splat and the bake, the peak memory, the vertex
    and face counts, the file sizes. Requires a non-empty mesh, every
    vertex inside the bounding box of the avatar's centres padded by
    EXPORT_PAD_CELLS grid cells, and no kernel launch; prints how far past
    the unpadded box the mesh reaches, in cells. Returns the launches."""
    import torch
    from gaussianip_tpu_torch import launch
    from gaussianip_tpu_torch.model.ply import state_to_ply
    from gaussianip_tpu_torch.ops import mesh_export, mesh_extract
    from gaussianip_tpu_torch.utils.config import load_config

    ply = os.path.join(tmp, "avatar_export.ply")
    state_to_ply(gs, ply)
    log_path = os.path.join(tmp, "export_logs")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "exp.yaml")
    ecfg = load_config(config)["system"]["exporter"]
    argv = ["--config", config, "--cur_time", "export", "--export",
            "--resume_from", ply, f"system.log_path={log_path}",
            "--device", dev]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with watch_calls((mesh_extract, "extract_density_grid"),
                     (mesh_extract, "marching_tetrahedra"),
                     (mesh_export, "splat_color_grid"),
                     (mesh_export, "bake_texture")) as calls:
        _, launches = count_launches(lambda: launch.main(argv))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with open(os.path.join(log_path, "export", "run.json")) as f:
        paths = json.load(f)["export"]
    verts, n_faces = [], 0
    with open(paths["obj"]) as f:
        for ln in f:
            if ln.startswith("v "):
                verts.append([float(x) for x in ln.split()[1:]])
            elif ln.startswith("f "):
                n_faces += 1
    verts = np.asarray(verts)
    n = gs.n_active
    xyz = gs.xyz[:n].cpu().numpy()
    lo, hi = xyz.min(0), xyz.max(0)
    cell = (2.0 / (int(ecfg["resolution"]) - 1)) / (1.8 / (hi - lo).max())
    past = (float(np.maximum(lo - verts, verts - hi).max()) / cell
            if len(verts) else float("nan"))
    inside = bool(past <= EXPORT_PAD_CELLS)
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    secs = {k: round(sum(s for s, _ in v), 4) for k, v in calls.items()}
    zero = {k: 0 for k in launches}
    log("export", resolution=ecfg["resolution"],
        density_thresh=ecfg["density_thresh"],
        texture_size=ecfg["texture_size"], fmt=ecfg["fmt"], gaussians=n,
        wall_s=round(wall, 3), seconds=secs,
        peak_above_start_gib=round(peak, 3), vertices=len(verts),
        faces=n_faces, bytes=sizes, cells_past_bbox=round(past, 3),
        inside_padded_bbox=inside,
        texture=os.path.basename(paths["texture"]), launches=launches)
    if not (inside and n_faces > 0 and set(paths) == {"obj", "mtl",
                                                      "texture"}
            and paths["texture"].endswith(".png") and launches == zero):
        raise AssertionError(f"export: {len(verts)} vertices, {n_faces} "
                             f"faces, inside {inside}, paths {paths}, "
                             f"launches {launches}")
    return launches


def viewer_phase(gs, dev="cuda"):
    """start_viewer(state, port=0) on the avatar: GET / and
    VIEWER_REQUESTS x /render?size=VIEWER_SIZE (the default orbit camera);
    the decoded PNG equals the port's render of the same camera as uint8,
    pixel for pixel; K1 once a request, K2 never. Returns the launches."""
    import urllib.request

    import torch
    from gaussianip_tpu_torch.render.render import RenderConfig, render
    from gaussianip_tpu_torch.utils.saving import decode_png
    from gaussianip_tpu_torch.utils.viewer import (ViewerState, orbit_camera,
                                                   start_viewer)

    state = ViewerState()
    state.update(gs)
    server = start_viewer(state, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read()
        pngs, ms = [], []

        def requests():
            for _ in range(VIEWER_REQUESTS):
                t0 = time.perf_counter()
                pngs.append(urllib.request.urlopen(
                    f"{url}/render?size={VIEWER_SIZE}", timeout=120).read())
                ms.append((time.perf_counter() - t0) * 1e3)

        _, launches = count_launches(requests)
    finally:
        server.shutdown()
        server.server_close()
    img = decode_png(pngs[-1])
    with torch.no_grad():
        want = render(gs, orbit_camera(0, 5, 1.8, VIEWER_SIZE, dev),
                      torch.zeros(3, device=dev), RenderConfig()).rgb[0]
    want = (want.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    equal = bool(np.array_equal(img, want))
    same = all(p == pngs[0] for p in pngs)
    expect = {"K1": VIEWER_REQUESTS, "K2": 0, "K3": 0,
              "K3_hopper": 0, "K3_general": 0}
    log("viewer", size=VIEWER_SIZE, requests=VIEWER_REQUESTS,
        ms_per_request=[round(x, 3) for x in ms], png_bytes=len(pngs[-1]),
        equal_to_render=equal, requests_identical=same,
        lit_share=round(float((want.max(-1) > 0).mean()), 4),
        page_ok=b"gaussianip-tpu viewer" in page, launches=launches)
    if not (equal and same and b"gaussianip-tpu viewer" in page):
        raise AssertionError(f"viewer: equal {equal}, identical {same}")
    check_launches("viewer", launches, expect)
    return launches


def npz_shapes(path) -> dict:
    """name -> (shape, dtype) of each array in an .npz, from the headers
    (the arrays are not read)."""
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}[
                    np.lib.format.read_magic(f)]
                shape, _, dtype = read(f)
            out[name[:-4]] = (shape, str(dtype))
    return out


class StepClock:
    """A logging handler that stamps each `step i:` line of the port's
    logger (one a step with trainer.log_every_n_steps=1; the metrics are
    host floats then, so the step has ended)."""

    def __init__(self):
        import logging

        self.stamps = []
        clock = self

        class _Handler(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("step "):
                    clock.stamps.append(time.perf_counter())

        self.handler = _Handler()

    def __enter__(self):
        import logging

        logging.getLogger("gaussianip_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("gaussianip_tpu_torch").removeHandler(self.handler)

    def median_ms(self, warmup: int = 2) -> float:
        return float(np.median(np.diff(self.stamps)[warmup:] * 1e3))


@contextlib.contextmanager
def patched(*targets):
    """For one block, replaces each (owner, name, make) attribute by
    make(original)."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    try:
        for owner, name, make in targets:
            setattr(owner, name, make(getattr(owner, name)))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def watch_calls(*targets):
    """For one block, wraps each (module, name) that the command line looks
    up at call time: yields {name: [(seconds, result if a bool else None),
    ...]}, each call's seconds taken after a CUDA sync."""
    import torch

    calls = {name: [] for _, name in targets}

    def timer(name):
        def wrap(fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                calls[name].append((time.perf_counter() - t0,
                                    out if isinstance(out, bool) else None))
                return out
            return timed
        return wrap

    with patched(*((mod, name, timer(name)) for mod, name in targets)):
        yield calls


# a module in a child process, run as `python -m` runs it (runpy, run_name
# "__main__"; the module's name is the first argument), then the child's
# kernel launch counts
MODULE_CHILD = (
    "import json, runpy, sys\n"
    "from gaussianip_tpu_torch.kernels import COUNTERS\n"
    "runpy.run_module(sys.argv.pop(1), run_name='__main__', alter_sys=True)\n"
    "print('launches=' + json.dumps({k: c.launches for k, c in "
    "COUNTERS.items()}), flush=True)\n")


def cli_kernel_checks(cfg, ply, gen):
    """K1 and the fused K2 against their plain versions at the command
    line's shapes, on its stub-trained state (the stage-1 .ply, loaded as
    stage 3 loads it): the validation render (1 x 1024^2, d_max 16), a
    handoff sweep (4 x 1024^2, d_max 16) and a stage-3 step (4 x
    (2 * stub_image_size)^2, RenderConfig())."""
    from gaussianip_tpu_torch import launch
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.sampler import (eval_orbit_batch,
                                                   refine_orbit_batch)
    from gaussianip_tpu_torch.model.ply import state_from_ply
    from gaussianip_tpu_torch.render.render import RenderConfig

    g = state_from_ply(ply, device="cuda")
    sys_cfg = cfg["system"]

    def orbit(res):
        return refine_orbit_batch(
            REFINE_VIEWS, float(sys_cfg["refine_elevation"]),
            float(sys_cfg["refine_camera_distance"]),
            float(sys_cfg["refine_fovy_deg"]), res, res, "cuda")

    val = eval_orbit_batch(launch.camera_config(cfg), "val", "cuda")
    h3 = 2 * CLI_STUB_SIZE
    stage3_views = [24, 8, 16, 0]
    shapes = {
        "val": (f"1 x {HIRES}^2, d_max {D_MAX}", camera_from_c2w(
            val.c2w[0:1], val.fovy[0:1], HIRES, HIRES), D_MAX),
        "handoff": (f"4 x {HIRES}^2, d_max {D_MAX}", camera_from_c2w(
            orbit(HIRES).c2w[0:4], orbit(HIRES).fovy[0:4], HIRES, HIRES),
            D_MAX),
        "stage3": (f"4 x {h3}^2, d_max {S3_D_MAX}", camera_from_c2w(
            orbit(h3).c2w[stage3_views], orbit(h3).fovy[stage3_views], h3,
            h3), S3_D_MAX)}
    out = {}
    for tag, (shape, cams, d_max) in shapes.items():
        info = check_kernels(g, cams, RenderConfig(d_max=d_max), gen,
                             f"cli:{tag}", timing=False)
        out[tag] = {"shape": shape, "fwd_err": info["fwd_err"],
                    "bwd_err": info["bwd_err"]}
    return out


def cli_phase():
    """The port's command line on the card in a temporary log directory:
    stage 1 and its --resume and stage 2 in-process through
    launch.main, stage 3 in a child process that runs the launch module as
    `python -m` does. Asserts each stage's run.json, the handoff files'
    shapes, the PNGs (decoded by the port's reader), last.ply, the video,
    the resumed step count, each stage's kernel launches (K1 and K2 in
    stages 1 and 3, K3 in stages 1 and 2; stage 3's counted in the child)
    and that the densify and the prune fired once each. Holds K1/K2 (on
    the stub-trained state) and the tiny stack's refine (K3) against their
    plain versions at the command line's shapes. Returns {"launches":
    {stage: launches}, "kernels": cli_kernel_checks, "refine_err": the
    refine's worst |diff|}."""
    import importlib.util
    import shutil
    import tempfile

    import torch
    from gaussianip_tpu_torch import launch
    from gaussianip_tpu_torch.model.ply import state_from_ply
    from gaussianip_tpu_torch.system import refine as refine_mod
    from gaussianip_tpu_torch.system import stage1 as s1
    from gaussianip_tpu_torch.utils import native_io, saving
    from gaussianip_tpu_torch.utils.checkpoint import LEAF_ORDER
    from gaussianip_tpu_torch.utils.config import load_config
    from gaussianip_tpu_torch.utils.saving import read_png

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "configs", "exp.yaml")
    log_path = tempfile.mkdtemp(prefix="gip_cli_")
    root = os.path.join(log_path, "cli")
    args = ["--config", config, "--cur_time", "cli", "--stub-guidance",
            f"system.log_path={log_path}", *CLI_OVERRIDES]
    # count the densify and prune calls of the stage-1 loop
    fired = {"densify": [], "prune": []}
    make_fns = s1.make_densify_fns

    def counted_densify_fns(cfg):
        densify, prune = make_fns(cfg)

        def d(ts, gen):
            out = densify(ts, gen)
            fired["densify"].append((ts.gaussians.n_active,
                                     out[0].gaussians.n_active))
            return out

        def p(ts):
            out = prune(ts)
            fired["prune"].append((ts.gaussians.n_active,
                                   out.gaussians.n_active))
            return out

        return d, p

    def manifest():
        with open(os.path.join(root, "run.json")) as f:
            return json.load(f)

    def want(stage, got, fwd, bwd, k3):
        """Launch counts: fwd and bwd exact, K3 > 0 when k3 else 0."""
        if not (got["K1"] == fwd and got["K2"] == bwd and (
                got["K3"] > 0 if k3 else got["K3"] == 0) and
                got["K3"] == got["K3_hopper"]
                + got["K3_general"]):
            raise AssertionError(f"cli {stage}: launches {got}; want K1 "
                                 f"{fwd}, K2 {bwd}, K3 "
                                 f"{'> 0' if k3 else 0}")

    # the stage-1 calls that chip_smoke times (the run manifest holds
    # launch.py's keys only)
    stage1_calls = ((s1, "train_stage1"), (refine_mod, "render_refine_views"),
                    (np, "savez"), (saving, "save_image"),
                    (native_io, "write_png_async"))

    def handoff_write_s(calls):
        """The handoff's npz (the last savez: checkpoints come before it)
        and its 32 PNGs."""
        return calls["savez"][-1][0] + sum(
            s for s, _ in calls["save_image"][-REFINE_VIEWS:])

    out = {}
    try:
        s1.make_densify_fns = counted_densify_fns
        t0 = time.perf_counter()
        with StepClock() as clock, watch_calls(*stage1_calls) as calls:
            _, got = count_launches(lambda: launch.main(
                [*args, "--train", "--stage", "stage1", "--max_steps",
                 str(CLI_STEPS)]))
        wall1 = time.perf_counter() - t0
        m = manifest()
        # CLI_STEPS steps, 1 validation render, 8 handoff sweeps of 4
        want("stage1", got, CLI_STEPS + 1 + REFINE_VIEWS // 4, CLI_STEPS,
             True)
        out["stage1"] = got
        for k, v in {"stage1": "done", "stage1_steps": CLI_STEPS,
                     "device": "cuda", "compute_dtype": "bfloat16",
                     "precision_policy": {"matmul_tf32": False,
                                          "cudnn_tf32": False},
                     "stage_requested": "stage1"}.items():
            if m.get(k) != v:
                raise AssertionError(f"cli stage1: run.json {k} = "
                                     f"{m.get(k)!r}, want {v!r}")
        if [len(fired["densify"]), len(fired["prune"])] != [1, 1]:
            raise AssertionError(f"cli stage1: densify/prune fired {fired}")
        native = [r for _, r in calls["write_png_async"]]
        if len(native) != 1:
            raise AssertionError(f"cli stage1: {len(native)} validation "
                                 f"PNGs, want 1")
        ck = os.path.join(root, "ckpt", "stage1_latest.npz")
        with np.load(ck) as d:
            ck_step = int(d[f"leaf_{LEAF_ORDER.index('step')}"])
        if ck_step != CLI_CKPT_STEP:
            raise AssertionError(f"cli stage1: checkpoint at step {ck_step}"
                                 f", want {CLI_CKPT_STEP}")
        shapes = npz_shapes(os.path.join(root, "before_refine.npz"))
        hand = ((REFINE_VIEWS, HIRES, HIRES, 3), "float32")
        if shapes != {"images": hand, "control_images": hand}:
            raise AssertionError(f"cli stage1: before_refine.npz {shapes}")
        native_io.flush()
        for name, shape in (("save/raw_rgb_0.png", (HIRES, HIRES, 3)),
                            ("save/raw_rgb_31.png", (HIRES, HIRES, 3)),
                            ("save/it10-0_rgb.png", (HIRES, HIRES, 3))):
            img = read_png(os.path.join(root, name))
            if img.shape != shape or img.max() == 0:
                raise AssertionError(f"cli: {name} {img.shape} max "
                                     f"{img.max()}")
        log("cli:stage1", steps=CLI_STEPS, wall_s=round(wall1, 3),
            median_ms_per_step=round(clock.median_ms(), 3),
            stage1_wall_s=m["stage1_wall_s"],
            train_s=round(calls["train_stage1"][0][0], 3),
            handoff_render_s=round(calls["render_refine_views"][0][0], 3),
            handoff_write_s=round(handoff_write_s(calls), 3),
            handoff_npz_bytes=os.path.getsize(os.path.join(
                root, "before_refine.npz")),
            val_png_writer="native" if native[0] else "python",
            densify=fired["densify"], prune=fired["prune"],
            checkpoint_step=ck_step,
            precision_policy=m["precision_policy"],
            compute_dtype=m["compute_dtype"], launches=got)

        t0 = time.perf_counter()
        with StepClock() as clock, watch_calls(*stage1_calls) as calls:
            _, got = count_launches(lambda: launch.main(
                [*args, "--train", "--stage", "stage1", "--resume",
                 "--max_steps", str(CLI_STEPS)]))
        wall = time.perf_counter() - t0
        left = CLI_STEPS - CLI_CKPT_STEP
        want("stage1", got, left + REFINE_VIEWS // 4, left, True)
        out["stage1_resume"] = got
        m = manifest()
        if m["stage1_steps"] != CLI_STEPS or not os.path.exists(m["ply"]):
            raise AssertionError(f"cli resume: stage1_steps "
                                 f"{m['stage1_steps']}, ply {m['ply']}")
        log("cli:resume", from_step=CLI_CKPT_STEP, steps=left,
            stage1_steps=m["stage1_steps"], wall_s=round(wall, 3),
            median_ms_per_step=round(clock.median_ms(0), 3),
            handoff_write_s=round(handoff_write_s(calls), 3), launches=got)
    finally:
        s1.make_densify_fns = make_fns
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        checks = cli_kernel_checks(load_config(config, *CLI_OVERRIDES),
                                   m["ply"], gen)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _, got = count_launches(lambda: launch.main(
            [*args, "--stage", "stage2"]))
        wall = time.perf_counter() - t0
        want("stage2", got, 0, 0, True)
        out["stage2"] = got
        m = manifest()
        small = npz_shapes(os.path.join(root, "after_refine.npz"))
        ref = {"refined_rgbs_small": ((REFINE_VIEWS, CLI_STUB_SIZE,
                                       CLI_STUB_SIZE, 3), "float32")}
        if m.get("stage2") != "done" or small != ref:
            raise AssertionError(f"cli stage2: {m.get('stage2')} {small}")
        img = read_png(os.path.join(root, "save", "refined_rgb_0.png"))
        if img.shape != (CLI_STUB_SIZE, CLI_STUB_SIZE, 3):
            raise AssertionError(f"cli stage2: refined_rgb_0 {img.shape}")
        log("cli:stage2", wall_s=round(wall, 3), launches=got)
        refine_err = check_refine_reference(CLI_STUB_SIZE)

        torch.cuda.empty_cache()
        out3, wall = child(["-c", MODULE_CHILD, "gaussianip_tpu_torch.launch",
                            *args, "--train", "--stage", "stage3",
                            "--max_steps", str(CLI_STEPS)], 900)
        got = child_launches(out3)
        want("stage3", got, CLI_STEPS + CLI_TEST_FRAMES // 4, CLI_STEPS,
             False)
        out["stage3"] = got
        m = manifest()
        h3 = 2 * CLI_STUB_SIZE  # stage 3 under --stub-guidance
        img = read_png(os.path.join(root, "save", "test", "0.png"))
        g = state_from_ply(m["final_ply"], device="cuda")
        if m.get("stage3") != "done" or img.shape != (h3, h3, 3) \
                or not os.path.exists(m["video"]) or g.n_active == 0 \
                or not bool(torch.isfinite(g.xyz[:g.n_active]).all()):
            raise AssertionError(f"cli stage3: {m.get('stage3')}, test png "
                                 f"{img.shape}, video {m['video']}, "
                                 f"n_active {g.n_active}")
        log("cli:stage3", steps=CLI_STEPS, res=h3, wall_s=round(wall, 3),
            stage3_wall_s=m["stage3_wall_s"], n_active=g.n_active,
            video=os.path.basename(m["video"]),
            video_bytes=os.path.getsize(m["video"]),
            optional_modules={k: importlib.util.find_spec(k) is not None
                              for k in ("cv2", "imageio", "yaml", "PIL",
                                        "tensorboardX")}, launches=got)
    finally:
        shutil.rmtree(log_path)
    return {"launches": out, "kernels": checks, "refine_err": refine_err}


def real_sources(gen):
    """The seeded random modules of the checkpoint set, on the card:
    build_random_sd15_guidance(seed=SEED)'s ControlNet and VAE and its
    UNet's weights under a random rank-LORA_RANK LoRA, a ProjPlusModel,
    CLIP-L, the ViT-H/14 and build_random_lpips(seed=SEED)."""
    import torch
    from dataclasses import replace

    from gaussianip_tpu_torch.diffusion.clip import (CLIPTextConfig,
                                                     CLIPTextModel,
                                                     CLIPVisionConfig,
                                                     CLIPVisionModel)
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.diffusion.unet import UNet2DConditionModel
    from gaussianip_tpu_torch.system import pipeline as pl

    unet0, cn, vae = pl.build_random_sd15_guidance(seed=SEED,
                                                   device="cuda").models
    unet = pl._build(lambda: UNet2DConditionModel(replace(
        unet0.cfg, lora_rank=LORA_RANK)), gen, "cuda")
    missing = unet.load_state_dict(unet0.state_dict(), strict=False)
    if missing.unexpected_keys or not all(
            "lora_" in k for k in missing.missing_keys):
        raise AssertionError(f"real: LoRA UNet keys {missing}")
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if "lora_up" in name:
                p.mul_(LORA_UP_SCALE)
    del unet0
    return {"unet": unet, "controlnet": cn, "vae": vae,
            "proj": pl._build(lambda: ProjPlusModel(), gen, "cuda"),
            "text_encoder": pl._build(lambda: CLIPTextModel(
                CLIPTextConfig(**CLIP_L)), gen, "cuda"),
            "vision_encoder": pl._build(lambda: CLIPVisionModel(
                CLIPVisionConfig(**VIT_H)), gen, "cuda"),
            "lpips": pl.build_random_lpips(SEED, "cuda")}


def rounded(module, dtype):
    """module's state dict on the CPU after a round trip through `dtype`
    (a file's rounding)."""
    return {k: v.detach().cpu().to(dtype).float() if v.is_floating_point()
            else v.detach().cpu() for k, v in module.state_dict().items()}


def assert_state_equal(tag, got, want: dict):
    sd = {k: v.detach().cpu() for k, v in got.state_dict().items()}
    if sd.keys() != want.keys():
        raise AssertionError(f"real:{tag}: keys differ by "
                             f"{sorted(sd.keys() ^ want.keys())[:5]}")
    bad = [k for k in sd if not torch_equal(sd[k], want[k])]
    if bad:
        raise AssertionError(f"real:{tag}: {len(bad)} tensors differ from "
                             f"the source, first {bad[:3]}")
    return len(sd)


def torch_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def folded_unet_state(unet, file_dt, ip_dt) -> dict:
    """What the loader should make of the source LoRA UNet, built from its
    own state dict in torch: every tensor rounded to its file's dtype (the
    IP projections to the IP-Adapter file's), and each projection with a
    LoRA folded as W + up @ down in float64 from the rounded factors, then
    rounded to the UNet file's dtype. -> {name: float32 CPU tensor}, the
    LoRA keys dropped."""
    import torch

    sd = {k: v.detach() for k, v in unet.state_dict().items()}
    out = {}
    for k, v in sd.items():
        if ".lora_" in k:
            continue
        if not v.is_floating_point():
            out[k] = v.cpu()
            continue
        if "_ip." in k:
            out[k] = v.to(ip_dt).float().cpu()
            continue
        down = sd.get(k.replace(".main.", ".lora_down."))
        if k.endswith(".main.weight") and down is not None:
            up = sd[k.replace(".main.", ".lora_up.")]
            v = (v.to(file_dt).double() + up.to(ip_dt).double()
                 @ down.to(ip_dt).double())
        out[k] = v.to(file_dt).float().cpu()
    return out


def assert_fold_close(got, want: dict, file_dt):
    """The loaded UNet against folded_unet_state: every tensor equal, but
    a folded one may differ by one step of `file_dt` at its value (the
    loader folds in float32, so a sum next to a midpoint of `file_dt` may
    round the other way). -> (tensors checked, {"tensors_not_equal": n,
    "elements_one_step_off": n})."""
    import torch

    sd = {k: v.detach() for k, v in got.state_dict().items()}
    if sd.keys() != want.keys():
        raise AssertionError(f"real:unet: keys differ by "
                             f"{sorted(sd.keys() ^ want.keys())[:5]}")
    fi = torch.finfo(file_dt)
    unequal = off = 0
    bad = []
    for k, w in want.items():
        g = sd[k].cpu()
        if torch_equal(g, w):
            continue
        step = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp(min=fi.tiny)))) * fi.eps
        unequal += 1
        if g.dtype != w.dtype or g.shape != w.shape or not bool(
                ((g - w).abs() <= step).all()):
            bad.append(k)
        off += int((g != w).sum())
    if bad:
        raise AssertionError(f"real:unet: {len(bad)} tensors differ from "
                             f"the source's fold, first {bad[:3]}")
    return len(sd), {"tensors_not_equal": unequal,
                     "elements_one_step_off": off}


def check_real_loaders(src, out, cfg):
    """The loaders on the card against their sources: each loaded tensor
    equals its source after the file's rounding (the UNet against
    folded_unet_state, a fold of the source's state dict that shares no
    code with the loader's), with each file's read seconds and bytes and
    each loader's seconds; then the loaded ControlNet + UNet against the
    source stack with the same folded weights on one CFG batch.
    -> {loader: {...}}."""
    import torch

    from gaussianip_tpu_torch.diffusion import weights as W
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system.standin import FILE_DTYPES

    g_cfg = cfg["system"]["guidance"]
    reads = []
    read = W.load_torch_state_dict

    def timed_read(path, *a, **kw):
        t0 = time.perf_counter()
        sd = read(path, *a, **kw)
        reads.append((os.path.basename(os.path.dirname(path)) + "/"
                      + os.path.basename(path), time.perf_counter() - t0,
                      os.path.getsize(path)))
        return sd

    def timed(name, fn):
        del reads[:]
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        info[name] = {"seconds": round(total, 3), "files": {
            f: {"read_s": round(s, 3), "bytes": b} for f, s, b in reads},
            "convert_and_move_s": round(total - sum(s for _, s, _ in reads),
                                        3)}
        return result

    info = {}
    W.load_torch_state_dict = timed_read
    try:
        models = timed("load_real_models",
                       lambda: pl.load_real_models(g_cfg, device="cuda"))
        proj = timed("load_ip_adapter_proj", lambda: pl.load_ip_adapter_proj(
            g_cfg["ip_ckpt_faceid_v2_path"], device="cuda"))
        encode = timed("load_text_encoder", lambda: pl.load_text_encoder(
            g_cfg["pretrained_realistic_model_name_or_path"], "cuda"))
        from gaussianip_tpu_torch.diffusion.clip import (load_clip_text,
                                                         load_clip_vision)
        text = timed("load_clip_text", lambda: load_clip_text(os.path.join(
            g_cfg["pretrained_realistic_model_name_or_path"],
            "text_encoder"), "cuda"))
        vision = timed("load_image_encoder", lambda: load_clip_vision(
            g_cfg["image_encoder_faceid_path"], "cuda"))
        lpips = timed("load_lpips", lambda: pl.load_lpips(cfg["system"],
                                                          "cuda"))
    finally:
        W.load_torch_state_dict = read
    dt = FILE_DTYPES

    # the UNet against a fold of the source's own state dict, made here
    # and not by the loader's code (see folded_unet_state)
    want_unet_sd = folded_unet_state(src["unet"], dt["unet"],
                                     dt["ip_adapter"])
    n_unet, unet_ulps = assert_fold_close(models.unet, want_unet_sd,
                                          dt["unet"])
    counts = {"unet": n_unet}
    info["unet_fold"] = unet_ulps
    for tag, got, mod, file_dt in (
            ("controlnet", models.controlnet, src["controlnet"],
             dt["controlnet"]),
            ("vae", models.vae, src["vae"], dt["vae"]),
            ("proj", proj, src["proj"], dt["ip_adapter"]),
            ("text_encoder", text, src["text_encoder"], dt["text_encoder"]),
            ("image_encoder", vision, src["vision_encoder"],
             dt["image_encoder"]),
            ("lpips", lpips, src["lpips"], torch.float32)):
        counts[tag] = assert_state_equal(tag, got, rounded(mod, file_dt))
    hidden = encode(["a person"])
    if hidden.shape != (1, 77, 768) or not np.isfinite(hidden).all():
        raise AssertionError(f"real: text encoder output {hidden.shape}")

    # the loaded stack against the source stack with the same weights: the
    # UNet's are the loaded folded ones, held against the independent fold
    # above (the one-step differences grow past REAL_FWD_TOL in bf16)
    del want_unet_sd
    with torch.device("meta"):
        want_unet = models.unet.__class__(models.unet.cfg)
        want_cn = models.controlnet.__class__(models.controlnet.cfg)
    want_unet.load_state_dict({k: v.detach().clone() for k, v in
                               models.unet.state_dict().items()},
                              assign=True)
    want_cn.load_state_dict(rounded(src["controlnet"], dt["controlnet"]),
                            assign=True)
    want_cn = want_cn.to("cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    b = 3 * BATCH
    lat = torch.randn((b, 4, RES // 8, RES // 8), device="cuda",
                      generator=g)
    ts = torch.randint(20, 980, (b,), device="cuda", generator=g)
    ctx = torch.randn((b, 81, 768), device="cuda", generator=g) * 0.5
    ctrl = torch.rand((b, 3, RES, RES), device="cuda", generator=g)

    @torch.no_grad()
    def call(unet, cn):
        down, mid = cn(lat, ts, ctx, ctrl, conditioning_scale=1.0)
        return unet(lat, ts, ctx, down_block_residuals=down,
                    mid_block_residual=mid, ip_scale=0.5).float()

    got = call(models.unet, models.controlnet)
    ref = call(want_unet, want_cn)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= REAL_FWD_TOL * scale):
        raise AssertionError(f"real: loaded stack vs source, max |diff| "
                             f"{err} (scale {scale})")
    info["tensors_checked"] = counts
    info["stack_forward"] = {"max_abs_err": err, "max_abs": scale,
                             "shape": f"CFG batch {b}, {RES // 8}^2 latents"}
    return info


def cli_real_phase():
    """The command line without --stub-guidance on a released-layout
    checkpoint set at the published widths (a temporary directory, deleted
    at the end): the set written from real_sources, the loaders checked on
    the card (check_real_loaders), stages 1 -> 2 -> 3 through launch.main
    with the set's overrides, then eval_avatar. Asserts each stage's
    run.json, that LPIPS was loaded, which face-identity branch ran (the
    JAX package's loudly warned fallback without insightface), each
    stage's K1/K2/K3 launches, and EVAL.json's keys. Returns {"launches":
    {stage: launches}, "loaders": ..., "face_identity": branch}."""
    import logging
    import shutil
    import tempfile

    import torch
    from gaussianip_tpu_torch import eval_avatar, launch
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system import refine as refine_mod
    from gaussianip_tpu_torch.system import stage1 as s1
    from gaussianip_tpu_torch.system.standin import (random_faces,
                                                     write_checkpoint_set)
    from gaussianip_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "configs", "exp.yaml")
    tmp = tempfile.mkdtemp(prefix="gip_real_")
    out = {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        src = real_sources(gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = write_checkpoint_set(
            os.path.join(tmp, "pretrained"), texts=[
                pl.RECIPE_PROMPT, pl.RECIPE_NEGATIVE_PROMPT,
                refine_mod.REFINE_NEGATIVE_PROMPT,
                "full body photo, left right front back view, overhead view"],
            faces=random_faces(SEED), **src)
        files = written["files"]
        sizes = {k: os.path.getsize(p) for k, p in files.items()}
        log("cli:real:write", build_s=round(build_s, 3),
            write_s=round(time.perf_counter() - t0, 3),
            total_bytes=sum(sizes.values()), bytes=sizes,
            params_m={k: round(sum(p.numel() for p in m.parameters()) / 1e6,
                               3) for k, m in src.items()})
        cfg = load_config(config, *written["overrides"])
        info = check_real_loaders(src, written, cfg)
        out_wp = weight_parity_phase(src, files, tmp)
        del src
        torch.cuda.empty_cache()
        for k, v in info.items():
            log(f"cli:real:{k}", **(v if isinstance(v, dict) else {"v": v}))

        log_path = os.path.join(tmp, "logs")
        root = os.path.join(log_path, "real")
        args = ["--config", config, "--cur_time", "real",
                f"system.log_path={log_path}", *written["overrides"],
                *CLI_REAL_OVERRIDES]
        warnings = []

        class _Warnings(logging.Handler):
            def emit(self, record):
                if record.levelno >= logging.WARNING:
                    warnings.append(record.getMessage())

        handler = _Warnings()
        logging.getLogger("gaussianip_tpu_torch").addHandler(handler)
        lpips_loaded = []
        load_lpips = pl.load_lpips

        def recorded_lpips(*a, **kw):
            lpips_loaded.append(load_lpips(*a, **kw))
            return lpips_loaded[-1]

        loaders = ((pl, "load_real_models"), (pl, "load_text_encoder"),
                   (pl, "load_image_encoder"), (pl, "load_ip_adapter_proj"),
                   (pl, "face_identity"), (s1, "train_stage1"),
                   (refine_mod, "render_refine_views"),
                   (refine_mod, "refine_views"))

        def manifest():
            with open(os.path.join(root, "run.json")) as f:
                return json.load(f)

        def stage(name, argv):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with StepClock() as clock, watch_calls(*loaders) as calls:
                _, got = count_launches(lambda: launch.main([*args, *argv]))
            wall = time.perf_counter() - t0
            out[name] = got
            return wall, clock, calls, got

        pl.load_lpips = recorded_lpips
        try:
            n = CLI_REAL_STEPS
            wall, clock, calls, got = stage("stage1", [
                "--train", "--stage", "stage1", "--max_steps", str(n)])
            m = manifest()
            want_k3 = K3_SITES * n
            if (got["K1"], got["K2"], got["K3"],
                    got["K3_hopper"]) != (n + 1 + REFINE_VIEWS // 4, n,
                                              want_k3, want_k3):
                raise AssertionError(f"cli:real stage1: launches {got}")
            if m.get("stage1") != "done" or m.get("stage1_steps") != n:
                raise AssertionError(f"cli:real stage1: run.json {m}")
            face = "fallback" if any("fallback face identity" in w
                                     for w in warnings) else "insightface"
            smplx = any("SMPL-X model not found" in w for w in warnings)
            if not smplx:
                raise AssertionError("cli:real: no synthetic-body warning")
            sec = lambda k: round(sum(s for s, _ in calls[k]), 3)
            log("cli:real:stage1", steps=n, wall_s=round(wall, 3),
                median_ms_per_step=round(clock.median_ms(), 3),
                stage1_wall_s=m["stage1_wall_s"],
                load_real_models_s=sec("load_real_models"),
                load_text_encoder_s=sec("load_text_encoder"),
                load_image_encoder_s=sec("load_image_encoder"),
                load_ip_adapter_proj_s=sec("load_ip_adapter_proj"),
                face_identity_s=sec("face_identity"),
                train_s=sec("train_stage1"),
                handoff_render_s=sec("render_refine_views"),
                peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                               3), face_identity=face,
                text_cache=len(os.listdir(os.path.join(root, "text_cache"))),
                launches=got)

            wall, _, calls, got = stage("stage2", ["--stage", "stage2"])
            want_k3 = K3_SITES * REFINE_STEPS * REFINE_CALLS_PER_STEP
            if (got["K1"], got["K2"], got["K3"],
                    got["K3_hopper"]) != (0, 0, want_k3, want_k3):
                raise AssertionError(f"cli:real stage2: launches {got}")
            small = npz_shapes(os.path.join(root, "after_refine.npz"))
            cy, cx = refine_mod.CROP_Y, refine_mod.CROP_X
            th = ((cy[1] - cy[0]) // 2, (cx[1] - cx[0]) // 2)
            if manifest().get("stage2") != "done" or small != {
                    "refined_rgbs_small": ((REFINE_VIEWS, *th, 3),
                                           "float32")}:
                raise AssertionError(f"cli:real stage2: {small}")
            log("cli:real:stage2", wall_s=round(wall, 3),
                load_real_models_s=sec("load_real_models"),
                refine_views_s=sec("refine_views"),
                peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                               3), launches=got)

            wall, _, _, got = stage("stage3", [
                "--train", "--stage", "stage3", "--max_steps", str(n)])
            if (got["K1"], got["K2"], got["K3"]) != (
                    n + CLI_TEST_FRAMES // 4, n, 0):
                raise AssertionError(f"cli:real stage3: launches {got}")
            m = manifest()
            if m.get("stage3") != "done" or not os.path.exists(
                    m["final_ply"]):
                raise AssertionError(f"cli:real stage3: run.json {m}")
            if len(lpips_loaded) != 1 or lpips_loaded[0] is None:
                raise AssertionError(f"cli:real stage3: LPIPS {lpips_loaded}")
            log("cli:real:stage3", steps=n, res=HIRES, wall_s=round(wall, 3),
                stage3_wall_s=m["stage3_wall_s"], lpips="loaded",
                peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30,
                               3), launches=got)
        finally:
            pl.load_lpips = load_lpips
            logging.getLogger("gaussianip_tpu_torch").removeHandler(handler)

        t0 = time.perf_counter()
        ev = eval_avatar.main(["--run", root, "--config", config, "--face",
                               files["face"], "--lpips-vgg",
                               files["lpips_vgg"], "--lpips-lin",
                               files["lpips_lin"]])
        with open(os.path.join(root, "EVAL.json")) as f:
            saved = json.load(f)
        if set(saved) != EVAL_KEYS or saved != ev or saved["render_size"] \
                != HIRES or not np.isfinite([saved[k] for k in (
                    "psnr", "ssim", "l1", "lpips_vgg")]).all():
            raise AssertionError(f"cli:real eval_avatar: {saved}")
        log("cli:real:eval", seconds=round(time.perf_counter() - t0, 3),
            **{k: v for k, v in saved.items() if k != "ply"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": out, "loaders": info, "face_identity": face,
            "weight_parity": out_wp}


def rel_err(a, b) -> float:
    """Worst |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def rel_l2(a, b) -> float:
    """||a - b|| over ||b||."""
    return float((a - b).double().norm()
                 / b.double().norm().clamp(min=1e-30))


def dp_compare(tag, got, ref, tol: float, err=rel_err) -> dict:
    """Adam's m of each field (rotation's, rounding noise on isotropic
    gaussians, aside) and the densify statistics of two train states:
    err(got, ref) (default: worst |diff| over the field's largest |value|)
    each within tol."""
    fields = {f"m.{f}": (got.opt.m[f], ref.opt.m[f])
              for f in ("xyz", "f_dc", "opacity", "scaling")}
    fields.update({f: (getattr(got.stats, f), getattr(ref.stats, f))
                   for f in ("xyz_grad_accum", "denom", "max_radii2d")})
    errs = {k: err(a, b) for k, (a, b) in fields.items()}
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{tag}: against the single process {bad} > "
                             f"{tol}")
    return errs


def dp_losses(tag, got: list, ref: list, rtol: float) -> float:
    """Each step's loss against the single process's, within rtol."""
    err = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    if not err <= rtol:
        raise AssertionError(f"{tag}: losses {got} against the single "
                             f"process's {ref}: {err} > {rtol}")
    return err


def guidance_half_batch_l2(guidance, gen, dev) -> float:
    """The guidance stack's sensitivity to its batch: the SDS gradient to
    BATCH random views (the step's loss over the whole batch, 512^2)
    computed as two half batches against one whole batch, relative L2."""
    import torch

    shape = (BATCH, RES, RES, 3)
    rgb = torch.rand(shape, generator=gen, device=dev)
    control = torch.rand(shape, generator=gen, device=dev)
    aux = view_aux(BATCH, dev)
    draws = guidance.sample_noise(gen, shape, dev)

    def grad(rows):
        x = rgb[rows].clone().requires_grad_(True)
        loss = guidance(0, {k: v[rows] for k, v in draws.items()}, x,
                        control[rows], {**{k: v[rows] for k, v in
                                           aux.items()},
                                        "batch_size": BATCH})["loss_sds"]
        return torch.autograd.grad(loss, x)[0]

    half = BATCH // 2
    whole = grad(slice(0, BATCH))
    return rel_l2(torch.cat([grad(slice(0, half)),
                             grad(slice(half, BATCH))]), whole)


def dp_stage1_f32(group, gs, points3d) -> dict:
    """Phase dp's f32 stage-1 steps (see DP_F32_LOSS_RTOL): the stub
    guidance on a camera batch whose depth max lies in the last rank's
    views, one step with the recipe's losses and one with the depth terms
    alone, each first in rank 0 without a group, then on every rank with
    it. Returns the rank's launches over the group steps; raises in rank 0,
    after every collective, when a step is off."""
    import dataclasses

    import torch
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   sample_train_batch)
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.parallel.mesh import check_replicated
    from gaussianip_tpu_torch.render.render import RenderConfig, render
    from gaussianip_tpu_torch.system import stage1 as s1

    dev = str(group.device)
    cfg = s1.Stage1Config(render_height=RES, render_width=RES)
    cam_cfg = CameraSamplerConfig(height=RES, width=RES, batch_size=BATCH)
    rcfg = RenderConfig(d_max=D_MAX)
    tgt = np.zeros((256, 256, 3), np.float32)
    tgt[64:192, 96:160] = 0.8
    stub = make_stub_guidance(target_rgb=tgt, noise_scale=0.01)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch = sample_train_batch(cam_cfg, gen, 0, dev)
    draws = stub.sample_noise(gen, (BATCH, RES, RES, 3), dev)
    # roll the views so that the one holding the batch's depth max is last
    with torch.no_grad():
        per_view = render(gs, camera_from_c2w(batch.c2w, batch.fovy, RES,
                                              RES),
                          torch.zeros(3, device=dev), rcfg).depth.flatten(
            1).amax(1)
    order = (torch.arange(BATCH, device=dev) + int(per_view.argmax()) + 1) \
        % BATCH
    batch, draws = type(batch)(*(x[order] for x in batch)), draws[order]
    others = per_view[order][:BATCH - BATCH // group.world_size]
    if not float(others.max()) < float(per_view.max()):
        raise AssertionError(f"dp:stage1_f32: the depth max {per_view} is "
                             f"not the last rank's alone")
    ts0 = s1.init_train_state(gs)
    cfgs = {"recipe": cfg,
            "depth": dataclasses.replace(cfg, lambda_sds=0.0,
                                         lambda_opaque=1.0)}

    def steps(grp):
        return {k: s1.make_inner_step(c, cam_cfg, rcfg, AdamHyper(), stub,
                                      points3d, group=grp)(ts0, batch, draws)
                for k, c in cfgs.items()}

    ref = steps(None) if group.rank == 0 else None
    got, launches = count_launches(lambda: steps(group))
    for k, (ts, _) in got.items():
        check_replicated(group, ts, f"dp:stage1_f32:{k}")
    if group.rank == 0:
        res, bad = {}, []
        for k in cfgs:
            (ts_g, m_g), (ts_r, m_r) = got[k], ref[k]
            loss, single = float(m_g["loss"]), float(m_r["loss"])
            err = abs(loss - single) / abs(single)
            errs = dp_compare("dp:stage1_f32", ts_g, ts_r, float("inf"))
            res[k] = {"loss": loss, "single_loss": single,
                      "loss_rel_err": err, "step_rel_err": errs}
            if not err <= DP_F32_LOSS_RTOL:
                bad.append(f"{k} loss {err}")
            bad += [f"{k} {f} {v}" for f, v in errs.items()
                    if not v <= BWD_REL_TOL]
        log("dp:stage1_f32", views_per_rank=BATCH // group.world_size,
            res=RES, view_depth_max=[float(x) for x in per_view[order]],
            loss_rtol=DP_F32_LOSS_RTOL, tol=BWD_REL_TOL, launches=launches,
            **res)
        if bad:
            raise AssertionError(f"dp:stage1_f32: against the single "
                                 f"process: {bad}")
    return launches


def dp_rank(group, scene_path: str, points3d):
    """One rank of phase dp (see DP_RANKS). Each part runs first in rank 0
    alone without a group (the single process), then on every rank with
    the group, its kernel launches counted from 0; rank 0 holds the two
    against each other and every rank checks that the ranks' states are
    bit-equal. Returns the rank's launches by part and its step times."""
    import torch
    import torch.distributed as dist
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   refine_orbit_batch,
                                                   sample_train_batch)
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.gaussians import GaussianState
    from gaussianip_tpu_torch.parallel.mesh import (DataGroup, all_max,
                                                    barrier,
                                                    check_replicated,
                                                    replicated)
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system import stage1 as s1
    from gaussianip_tpu_torch.system.refine import (crop_and_downsample,
                                                    refine_views,
                                                    render_refine_views)
    from gaussianip_tpu_torch.system.stage3 import (Stage3Config,
                                                    draw_view_ids,
                                                    make_stage3_step)

    from gaussianip_tpu_torch import set_precision_policy

    set_precision_policy()  # as the parent's
    torch.backends.cuda.enable_cudnn_sdp(False)  # see DP_RANKS
    dev = str(group.device)
    main = group.rank == 0
    gs = GaussianState(**{k: v.to(dev) if isinstance(v, torch.Tensor)
                          else v for k, v in torch.load(scene_path).items()})
    gs = replicated(group, gs)
    out = {"launches": {}, "ms": {}}

    def part(name, fn):
        """(fn(group), fn(None) in rank 0, else None)."""
        t0 = time.perf_counter()
        ref = fn(None) if main else None
        single_s = time.perf_counter() - t0
        barrier(group)
        t0 = time.perf_counter()
        got, out["launches"][name] = count_launches(lambda: fn(group))
        out["ms"][name] = {"part_s": time.perf_counter() - t0,
                           "single_part_s": single_s}
        return got, ref

    # stage 1: the f32 steps, then the guided steps and the densify
    out["launches"]["stage1_f32"] = dp_stage1_f32(group, gs, points3d)
    guidance = pl.build_random_sd15_guidance(seed=SEED, device=dev)
    cfg = s1.Stage1Config(render_height=RES, render_width=RES)
    cam_cfg = CameraSamplerConfig(height=RES, width=RES, batch_size=BATCH)
    rcfg = RenderConfig(d_max=D_MAX)
    densify, _ = s1.make_densify_fns(cfg)

    def stage1(grp):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step = s1.make_train_step(cfg, cam_cfg, rcfg, AdamHyper(), guidance,
                                  points3d, group=grp)
        ts, r = s1.init_train_state(gs), {"losses": [], "ms": []}
        for i in range(DP_STEPS):
            t0 = time.perf_counter()
            ts, m = step(ts, gen)
            r["losses"].append(float(m["loss"]))  # waits for the step
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                r["first"] = ts
            if i == DP_DENSIFY_AT:
                r["n_before"] = ts.gaussians.n_active
                ts, _ = densify(ts, gen)
        check_replicated(grp, ts, "dp:stage1")
        r["n_after"] = ts.gaussians.n_active
        return r

    got, ref = part("stage1", stage1)
    out["ms"]["stage1"].update(ms_per_step=got["ms"])
    if main:
        floor = guidance_half_batch_l2(guidance, torch.Generator(
            device=dev).manual_seed(SEED), dev)
        tol = max(DP_GUIDED_FACTOR * floor, DP_GUIDED_MIN)
        errs = dp_compare("dp:stage1", got["first"], ref["first"], tol,
                          rel_l2)
        worst = dp_compare("dp:stage1", got["first"], ref["first"],
                           float("inf"))
        n_g, n_r = got["n_after"], ref["n_after"]
        if abs(n_g - n_r) > DP_COUNT_RTOL * n_r:
            raise AssertionError(f"dp:stage1: {n_g} gaussians after the "
                                 f"densify against the single process's "
                                 f"{n_r}")
        log("dp:stage1", views_per_rank=BATCH // group.world_size,
            res=RES, steps=DP_STEPS, losses=got["losses"],
            single_losses=ref["losses"],
            loss_rel_err=dp_losses("dp:stage1", got["losses"],
                                   ref["losses"], DP_LOSS_RTOL),
            loss_rtol=DP_LOSS_RTOL, step1_rel_l2=errs,
            half_batch_rel_l2=floor,
            step1_tol=tol, step1_worst_rel=worst,
            n_before_densify=got["n_before"],
            n_after_densify=n_g, single_n_after_densify=n_r,
            ms_per_step=[round(x, 3) for x in got["ms"]],
            single_ms_per_step=[round(x, 3) for x in ref["ms"]],
            launches=out["launches"]["stage1"])
    del got, ref

    # stage 3 on the handoff views of the scene (each view's target: the
    # crop of its neighbour's render)
    lpips = pl.build_random_lpips(SEED, dev)
    orbit = refine_orbit_batch(REFINE_VIEWS, 17.0, 1.5, 70.0, HIRES, HIRES,
                               device=dev)
    own = render_refine_views(gs, orbit, points3d, HIRES, HIRES, rcfg)
    # every rank takes rank 0's views, as every rank of the command line
    # reads one before_refine.npz; how far each rank's own were from them
    images, poses = replicated(group, own)
    own_diff = {k: float(all_max(group, (a - b).abs().max()))
                for k, a, b in zip(("images", "poses"), own, (images, poses))}
    del own
    targets = crop_and_downsample(images.roll(1, dims=0))
    cfg3 = Stage3Config()
    rcfg3 = RenderConfig(d_max=S3_D_MAX)
    ids = draw_view_ids(torch.Generator(device=dev).manual_seed(SEED),
                        REFINE_VIEWS, cfg3.train_bs, DP_S3_STEPS, dev)

    def stage3(grp):
        step = make_stage3_step(cfg3, rcfg3, AdamHyper(), orbit, targets,
                                lpips, grp)
        ts, r = s1.init_train_state(gs), {"losses": [], "ms": []}
        for i in range(DP_S3_STEPS):
            t0 = time.perf_counter()
            ts, m = step(ts, ids[i])
            r["losses"].append(float(m["loss"]))
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                r["first"] = ts
        check_replicated(grp, ts, "dp:stage3")
        return r

    got, ref = part("stage3", stage3)
    out["ms"]["stage3"].update(ms_per_step=got["ms"])
    if main:
        errs = dp_compare("dp:stage3", got["first"], ref["first"],
                          BWD_REL_TOL)
        log("dp:stage3", views_per_rank=cfg3.train_bs // group.world_size,
            res=HIRES, steps=DP_S3_STEPS, losses=got["losses"],
            single_losses=ref["losses"],
            loss_rel_err=dp_losses("dp:stage3", got["losses"],
                                   ref["losses"], DP_S3_RTOL),
            loss_rtol=DP_S3_RTOL, step1_rel_err=errs, step1_tol=BWD_REL_TOL,
            ms_per_step=[round(x, 3) for x in got["ms"]],
            single_ms_per_step=[round(x, 3) for x in ref["ms"]],
            launches=out["launches"]["stage3"])
    del got, ref, lpips

    # stage 2: refine_views, dense groups of 8 split over the ranks
    models = pl.refine_models(guidance)
    contexts = pl.random_refine_contexts(SEED, dev)
    side = HIRES // models.vae.cfg.downscale
    noise = torch.randn((4, side, side), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))

    def refine(grp):
        views = refine_views(models, images, poses, contexts, noise,
                             num_steps=DP_REFINE_STEPS,
                             dense_batch=4 if grp is None else 8, group=grp)
        check_replicated(grp, views, "dp:refine")
        return views

    got, ref = part("refine", refine)
    check_images("dp:refine", got, images.shape)
    if main:
        views = (got - ref).abs().flatten(1).amax(1)
        err = float(views.max())
        if not err <= DP_REFINE_TOL:
            raise AssertionError(f"dp:refine: worst {err} (tol "
                                 f"{DP_REFINE_TOL}) against the single "
                                 f"process")
        log("dp:refine", views=REFINE_VIEWS, res=HIRES,
            steps=DP_REFINE_STEPS, max_abs_err=err, tol=DP_REFINE_TOL,
            views_differing=int((views > 0).sum()),
            handoff_own_vs_rank0=own_diff,
            wall_s=round(out["ms"]["refine"]["part_s"], 3),
            single_wall_s=round(out["ms"]["refine"]["single_part_s"], 3),
            launches=out["launches"]["refine"])
    del got, ref, models, guidance
    torch.cuda.empty_cache()

    # one stub-guided step through the group path in a world-size-1 NCCL
    # group (rank 0), against the step without a group
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    pg = dist.new_group([0], backend=backend)
    if main:
        tgt = np.zeros((256, 256, 3), np.float32)
        tgt[64:192, 96:160] = 0.8
        stub = make_stub_guidance(target_rgb=tgt, noise_scale=0.01)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        batch = sample_train_batch(cam_cfg, gen, 0, dev)
        draws = stub.sample_noise(gen, (BATCH, RES, RES, 3), dev)
        ts0 = s1.init_train_state(gs)
        args = (cfg, cam_cfg, rcfg, AdamHyper(), stub, points3d)
        ref_ts, ref_m = s1.make_inner_step(*args)(ts0, batch, draws)
        one = DataGroup(0, 1, group.device, pg)
        (got_ts, got_m), launches = count_launches(
            lambda: s1.make_inner_step(*args, group=one)(ts0, batch, draws))
        if float(got_m["loss"]) != float(ref_m["loss"]):
            raise AssertionError(f"dp:nccl: loss {float(got_m['loss'])} "
                                 f"!= {float(ref_m['loss'])}")
        errs = dp_compare("dp:nccl", got_ts, ref_ts, BWD_REL_TOL)
        out["launches"]["nccl"] = launches
        log("dp:nccl", backend=dist.get_backend(pg), world_size=1,
            loss=float(got_m["loss"]), rel_err=errs, tol=BWD_REL_TOL,
            launches=launches)
        # K1 / K2 against their plain versions at one rank's shapes
        check_kernels(gs, camera_from_c2w(
            batch.c2w[:BATCH // group.world_size],
            batch.fovy[:BATCH // group.world_size], RES, RES), rcfg, gen,
            "dp", timing=False)
    barrier(group)
    return out


def dp_phase(gs, sk, dev="cuda"):
    """Phase dp: DP_RANKS gloo ranks on `dev` through parallel.spawn from
    the scene `gs` (see DP_RANKS). Every kernel must launch in every rank
    as many times as its parts make it; returns each rank's launches over
    the gloo parts (the f32 and guided stage 1, stage 3, the refine)."""
    import tempfile

    import torch
    from gaussianip_tpu_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.pt")
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in vars(gs).items()}, path)
        t0 = time.perf_counter()
        card = "cuda:0" if dev == "cuda" else dev  # both ranks on card 0
        res = spawn(DP_RANKS, dp_rank, path, np.asarray(sk.points3d),
                    backend="gloo", devices=[card] * DP_RANKS)
        wall = time.perf_counter() - t0
    # a refine step: anchors, keys and 3 dense groups of 8 (4 a rank)
    calls = DP_REFINE_STEPS * 5
    k3 = K3_SITES * (DP_STEPS + calls)
    renders = 2 + DP_STEPS + DP_S3_STEPS  # dp_stage1_f32 makes 2 steps
    want = {"K1": renders, "K2": renders, "K3": k3,
            "K3_hopper": k3, "K3_general": 0}
    totals = []
    for r, out in enumerate(res):
        tot = {k: sum(out["launches"][p][k] for p in (
            "stage1_f32", "stage1", "stage3", "refine")) for k in want}
        if tot != want:
            raise AssertionError(f"dp: rank {r} launches {tot} != {want}")
        totals.append(tot)
    log("dp", ranks=DP_RANKS, backend="gloo", device=dev,
        wall_s=round(wall, 3), launches_by_rank=totals,
        nccl_launches=res[0]["launches"]["nccl"],
        seconds_by_rank=[{p: {k: (round(v, 3) if isinstance(v, float)
                                  else [round(x, 3) for x in v])
                              for k, v in m.items()}
                          for p, m in out["ms"].items()} for out in res])
    return totals


def child(argv, timeout: int):
    """A child process from the checkout's root; raises with its output
    unless it exits 0. -> (its stdout, seconds)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=repo,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{argv[:3]}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def child_launches(stdout: str) -> dict:
    """The launch counts that MODULE_CHILD prints last."""
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("launches=")][-1][9:])


def render_ply_phase(gs, tmp: str):
    """`python -m gaussianip_tpu_torch.render_ply` on the final avatar's
    .ply at 1024^2 in a child process (MODULE_CHILD) from RENDER_PLY_VIEW:
    its two lines, one K1 launch, and its PNG equal to an in-process
    render of the same camera on the card after the writer's 8-bit
    conversion. -> the child's launches."""
    import torch
    from gaussianip_tpu_torch.model.ply import state_from_ply, state_to_ply
    from gaussianip_tpu_torch.render.render import RenderConfig, render
    from gaussianip_tpu_torch.render_ply import orbit_camera
    from gaussianip_tpu_torch.utils.saving import read_png, save_image

    v = RENDER_PLY_VIEW
    ply = os.path.join(tmp, "final.ply")
    png, here = os.path.join(tmp, "child.png"), os.path.join(tmp, "here.png")
    state_to_ply(gs, ply)
    out, wall = child(["-c", MODULE_CHILD, "gaussianip_tpu_torch.render_ply",
                       "--ply", ply, "--azimuth", str(v["azimuth"]),
                       "--elevation", str(v["elevation"]), "--radius",
                       str(v["radius"]), "--fovy", str(v["fovy"]), "--size",
                       str(HIRES), "--bg", *map(str, v["bg"]), "--out", png],
                      300)
    launches = child_launches(out)
    g = state_from_ply(ply, device="cuda")
    with torch.no_grad():
        ref = render(g, orbit_camera(v["azimuth"], v["elevation"],
                                     v["radius"], v["fovy"], HIRES, "cuda"),
                     torch.tensor(v["bg"], device="cuda"), RenderConfig())
    save_image(here, ref.rgb[0].cpu().numpy())
    got, want = read_png(png), read_png(here)
    lines = out.strip().splitlines()[:2]
    expect = [f"loaded {g.n_active} gaussians (sh degree {g.max_sh_degree}) "
              f"from {ply}", f"wrote {png} (alpha coverage "
              f"{float(ref.alpha.mean()):.3f})"]
    if lines != expect:
        raise AssertionError(f"render_ply: printed {lines}, want {expect}")
    if got.shape != (HIRES, HIRES, 3) or not np.array_equal(got, want):
        raise AssertionError(
            f"render_ply: PNG {got.shape} differs from the in-process render "
            f"at {int((got != want).any(axis=-1).sum())} pixels")
    want_l = {"K1": 1, "K2": 0, "K3": 0, "K3_hopper": 0,
              "K3_general": 0}
    check_launches("render_ply", launches, want_l)
    log("render_ply", res=HIRES, n_active=g.n_active, wall_s=round(wall, 3),
        alpha_coverage=float(ref.alpha.mean()), png_equal=True,
        launches=launches)
    return launches


def compare_lines(stdout: str) -> dict:
    """{output key: "OK" or "FAIL"} of weight_parity compare's lines."""
    return {ln.split(":")[0]: ln.rsplit(" ", 1)[1]
            for ln in stdout.splitlines()
            if "max_abs_err=" in ln}


def weight_parity_phase(src, files: dict, tmp: str):
    """`python -m gaussianip_tpu_torch.weight_parity compare` on the
    released-layout set at the published widths (cli:real's), in child
    processes. The recording: the set's source modules (UNet with the
    IP-Adapter's LoRA and IP projections, ControlNet, VAE), each tensor
    rounded to its file's dtype, at float32 on the CPU on fixed_inputs().
    compare must pass it (exit 0, every output OK; K3 runs the UNet's and
    ControlNet's 67 stride-1 3x3 convs), then fail (exit 1) with
    PLANTED_TENSOR moved by PLANTED_SHIFT in a copy of the UNet file,
    naming unet_out and nothing else. -> compare's launches."""
    import torch
    from dataclasses import replace

    from gaussianip_tpu_torch import weight_parity as wp
    from gaussianip_tpu_torch.diffusion.weights import read_safetensors
    from gaussianip_tpu_torch.system.standin import (FILE_DTYPES,
                                                     write_safetensors)

    t0 = time.perf_counter()
    cpu = {}
    for name in ("unet", "vae", "controlnet"):
        m = src[name]
        with torch.device("meta"):
            cpu[name] = m.__class__(replace(m.cfg, dtype=torch.float32))
        cpu[name].load_state_dict(rounded(m, FILE_DTYPES[name]),
                                  assign=True)
    x = wp.fixed_inputs()
    ref = {**x, **wp.outputs(x, **{k: m.eval() for k, m in cpu.items()})}
    del cpu
    path = os.path.join(tmp, "weight_parity_ref.npz")
    np.savez(path, **ref)
    record_s = time.perf_counter() - t0
    argv = ["-m", "gaussianip_tpu_torch.weight_parity", "compare", "--ref",
            path, "--unet", files["unet"], "--ipa", files["ip_adapter"],
            "--vae", files["vae"], "--controlnet", files["controlnet"]]
    out, wall = child(argv, 600)
    checks = compare_lines(out)
    keys = sorted(k for k in ref if k not in x)
    if sorted(checks) != keys or set(checks.values()) != {"OK"}:
        raise AssertionError(f"weight_parity: {checks}\n{out}")
    launches = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
    check_launches("weight_parity", launches,
                   {"K1": 0, "K2": 0, "K3": K3_SITES})
    errs = {ln.split(":")[0]: ln.split("=", 1)[1].rsplit(" ", 1)[0]
            for ln in out.splitlines() if "max_abs_err=" in ln}

    sd, _ = read_safetensors(files["unet"])
    sd[PLANTED_TENSOR] = sd[PLANTED_TENSOR] + PLANTED_SHIFT
    bad = os.path.join(tmp, "planted_unet.safetensors")
    write_safetensors(bad, sd)
    del sd
    argv[argv.index(files["unet"])] = bad
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, *argv], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    planted = compare_lines(proc.stdout)
    if proc.returncode != 1 or planted.get("unet_out") != "FAIL" or any(
            v != "OK" for k, v in planted.items() if k != "unet_out"):
        raise AssertionError(f"weight_parity planted: exit "
                             f"{proc.returncode}, {planted}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    log("weight_parity", record_cpu_f32_s=round(record_s, 3),
        compare_s=round(wall, 3), max_abs_err=errs, launches=launches,
        planted=f"{PLANTED_TENSOR} + {PLANTED_SHIFT}: exit 1, unet_out "
                f"FAIL, the rest OK")
    return launches


def bench_phase(tmp: str):
    """`python -m gaussianip_tpu_torch.bench_pipeline` in a child process,
    stage 3 cut to BENCH_S3_STEPS (its line goes to a temporary file):
    every key of BENCH_KEYS present and finite, the card's name in it, and
    each stage's launches as its schedule makes them (stage 1: a K1, a K2
    and K3_SITES K3 a step; stage 2: K3_SITES a denoise call; stage 3: a K1
    and a K2 a step; the denoise: K3_SITES a call; K3 all on the Hopper
    variant). Prints the line. -> {stage: launches}."""
    import torch
    from gaussianip_tpu_torch import bench_pipeline as bp

    out, wall = child(["-m", "gaussianip_tpu_torch.bench_pipeline", "123",
                       "--stage3-steps", str(BENCH_S3_STEPS), "--out",
                       os.path.join(tmp, "bench.json")], 900)
    line = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    bad = [k for k in BENCH_KEYS if not isinstance(line.get(k), (int, float))
           or not np.isfinite(line[k])]
    if bad or line["device"]["kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench: keys {bad}, device {line['device']}")
    s1 = 1 + bp.STAGE1_WARMUP + bp.STAGE1_TIMED
    calls = 2 * REFINE_STEPS * REFINE_CALLS_PER_STEP
    denoise = 2 + bp.TIMED_CALLS
    want = {"stage1": (s1, s1, K3_SITES * s1),
            "stage2": (0, 0, K3_SITES * calls),
            "stage3": (BENCH_S3_STEPS, BENCH_S3_STEPS, 0),
            "denoise": (0, 0, K3_SITES * denoise)}
    launches = {k: line[f"launches_{k}"] for k in (*want, "render")}
    for k, (k1, k2, k3) in want.items():
        got = launches[k]
        if (got["K1"], got["K2"], got["K3"], got["K3_hopper"]) != (
                k1, k2, k3, k3):
            raise AssertionError(f"bench {k}: launches {got}, want K1 {k1} "
                                 f"K2 {k2} K3 {k3} (all Hopper)")
    r = launches["render"]
    if not (r["K1"] > 0 and r["K2"] > 0 and r["K3"] == 0):
        raise AssertionError(f"bench render: launches {r}")
    log("bench", wall_s=round(wall, 3), cut=line["cut"],
        stage3_steps=line["stage3_steps"])
    return launches


def kernel_bound(info, kind_, ops="ops"):
    """(bound ms, "bytes" or "operations") of K1 ("fwd") or K2 ("bwd") from
    check_kernels' counts."""
    t_bytes = info[f"{kind_}_bytes"] / PEAK_BYTES * 1e3
    t_ops = info[f"{kind_}_{ops}"] / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gaussianip_tpu_torch import _nvcc, set_precision_policy
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   sample_train_batch)
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import stage1 as s1
    from gaussianip_tpu_torch.diffusion.scheduler import make_ddim_schedule
    from gaussianip_tpu_torch.system.pipeline import (
        build_random_sd15_guidance, random_refine_contexts, refine_models)
    from gaussianip_tpu_torch.system.refine import make_refine_step

    dev = "cuda"
    # 1. device
    policy = set_precision_policy()
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("device", name=repr(kind), smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, precision_policy=policy)

    # 2. build
    t0 = time.perf_counter()
    libs = _nvcc.build(_nvcc.LIBRARIES)  # every library a wrapper binds
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for name in libs
            for ln in _nvcc.ptxas_log.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]
    log("build", seconds=round(build_s, 2), ptxas=regs)
    for name, counts in sass_counts(libs["composite"], _nvcc._nvcc()).items():
        for kernel in ("composite_fwd_kernel", "composite_bwd_kernel"):
            if kernel in name:
                log("build:sass", kernel=kernel, **counts)
    from gaussianip_tpu_torch.ops.conv3x3_cuda import hopper_smem_bytes
    for name, lines in ptxas_entries(_nvcc.ptxas_log.get("conv3x3",
                                                         "")).items():
        if "conv3x3_wgmma_kernel" in name:
            bn = int(name.split("ILi")[1].split("E")[0])
            log("build:k3_hopper", bn=bn, ptxas=lines,
                dynamic_smem_bytes=hopper_smem_bytes(bn))

    # 3. full-size scene
    t0 = time.perf_counter()
    sk, gs0 = build_scene(dev)
    torch.cuda.synchronize()
    log("scene", points=PTS_NUM, capacity=gs0.capacity,
        n_active=gs0.n_active, seconds=round(time.perf_counter() - t0, 2))

    # the FLUX.1-dev stack's guided steps at the published widths (alone
    # with `python3 chip_smoke.py flux`)
    flux = flux_phase(gs0, sk, dev)
    if sys.argv[1:] == ["flux"]:
        print(json.dumps({"ok": True, "flux": flux, "device": {
            "name": kind, "smi": smi}}), flush=True)
        return 0

    # 4. kernels vs plain at the slice's shapes
    rcfg = RenderConfig(d_max=D_MAX)
    cam_cfg = CameraSamplerConfig(height=RES, width=RES, batch_size=BATCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    batch = sample_train_batch(cam_cfg, gen, 0, dev)
    cams = camera_from_c2w(batch.c2w, batch.fovy, RES, RES)
    info = check_kernels(gs0, cams, rcfg, gen, "init", timing=True)
    hard = gs0.replace(opacity=gs0.opacity.clone())
    hard.opacity[:PTS_NUM].uniform_(-2.0, 4.0, generator=gen)
    check_kernels(hard, cams, rcfg, gen, "opaque", timing=False)
    check_oracle(gs0, dev)

    # 5. stage-1 steps at the recipe's sizes with stub guidance
    tgt = np.zeros((256, 256, 3), np.float32)
    tgt[64:192, 96:160] = 0.8
    guidance = make_stub_guidance(target_rgb=tgt, noise_scale=0.01)
    ts, cfg, launches, _ = train_phase(
        "stage1", gs0, sk, guidance, gen, cam_cfg, rcfg, N_STEPS,
        WARMUP_STEPS, {"K1": N_STEPS, "K2": N_STEPS, "K3": 0,
                       "K3_hopper": 0, "K3_general": 0})
    profile_steps(ts, cfg, cam_cfg, rcfg, guidance, sk.points3d, gen)

    densify, prune = s1.make_densify_fns(cfg)
    stats = ts.stats
    n0 = ts.gaussians.n_active
    t0 = time.perf_counter()
    ts_d, dropped = densify(ts, gen)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts_p = prune(ts_d)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    for name, t in (("densify", ts_d), ("prune", ts_p)):
        for f in PARAM_FIELDS:
            if not torch.isfinite(getattr(t.gaussians, f)).all():
                raise AssertionError(f"{name}: non-finite {f}")
    log("densify_prune", n_before=n0, hot=int((stats.xyz_grad_accum
        / stats.denom.clamp(min=1) >= cfg.max_grad).sum()),
        n_after_densify=ts_d.gaussians.n_active, dropped=dropped,
        n_after_prune=ts_p.gaussians.n_active, densify_s=round(t_d, 4),
        prune_s=round(t_p, 4))

    # 6. the real guidance: the tiny stack on the card against the CPU, then
    # at full width K3 at every conv shape of the guided step and guided
    # stage-1 steps at the recipe's sizes
    guidance_errs = check_guidance_reference(dev)
    t0 = time.perf_counter()
    guidance = build_random_sd15_guidance(seed=SEED, device=dev)
    torch.cuda.synchronize()
    log("guidance_stack", seconds=round(time.perf_counter() - t0, 2),
        params_m={k: round(sum(p.numel() for p in m.parameters()) / 1e6, 3)
                  for k, m in guidance.models._asdict().items()})
    k3 = check_k3(conv_sites(guidance, gen, BATCH, RES, dev), gen, dev)
    k4 = check_k4(guidance.models.vae, gen, dev)
    k5 = check_k5(gen, dev)
    from gaussianip_tpu_torch.ops import groupnorm_cuda
    from gaussianip_tpu_torch.ops import vae_attention_cuda
    # a step's encode: 22 GroupNorms (K4) and one attention over BATCH
    # views (K5), forward and backward; the denoise replays its graph
    use_g = dict(DENOISE_GRAPH_USE)
    ts_g, cfg_g, launches_g, med_g = train_phase(
        "stage1_guided", gs0, sk, guidance, gen, cam_cfg, rcfg, N_GUIDED,
        GUIDED_WARMUP, {"K1": N_GUIDED, "K2": N_GUIDED,
                        "K3": K3_SITES * N_GUIDED,
                        "K3_hopper": K3_SITES * N_GUIDED,
                        "K3_general": 0,
                        "K4_fwd": 22 * groupnorm_cuda.FWD_KERNELS * N_GUIDED,
                        "K4_bwd": 22 * groupnorm_cuda.BWD_KERNELS * N_GUIDED,
                        "K5_fwd": vae_attention_cuda.fwd_launches(BATCH)
                        * N_GUIDED,
                        "K5_bwd": vae_attention_cuda.bwd_launches(BATCH)
                        * N_GUIDED})
    use = {k: v - use_g[k] for k, v in DENOISE_GRAPH_USE.items()}
    log("denoise_graph_use", path="stage1_guided", **use)
    # conv_sites' guidance call captured the step's signature
    if use != {"captures": 0, "replays": N_GUIDED, "eager": 0}:
        raise AssertionError(f"stage1_guided: the denoise graph's use {use}")
    dg = check_denoise_graph(guidance, gen, BATCH, RES, dev)
    layers = guided_layers(guidance, gen, BATCH, RES, dev)
    log("guided_layers", **{k: round(v, 3) for k, v in layers.items()},
        rest_of_step_ms=round(med_g - layers["vae_fwd_bwd_ms"]
                              - layers["denoise_ms"], 3))
    profile_steps(ts_g, cfg_g, cam_cfg, rcfg, guidance, sk.points3d, gen,
                  n=2, tag="profile_guided")

    # 7. stages 2 and 3 from the stub-trained, densified and pruned state:
    # the handoff, K3 at the refine's conv shapes, the tiny refine on the
    # card against the CPU, the refine at 1024^2, K1/K2 at stage 3's shapes,
    # stage-3 steps and the turntable
    g2, orbit, images, poses, launches_h = handoff(ts_p, sk, rcfg)
    models = refine_models(guidance)
    contexts = random_refine_contexts(SEED, dev)
    run = make_refine_step(models, make_ddim_schedule(device=dev), 7.5, 0.6)
    lat, ctx, ctrl = refine_call_inputs(models, contexts, images, poses, gen)
    k3_r = check_k3(collect_conv_sites(
        (models.controlnet, models.unet),
        lambda: run(lat, 143, 122, ctx, ctrl, "store")), gen, dev,
        tag="k3:refine")
    profile_window(lambda: run(lat, 143, 122, ctx, ctrl, "store"), 2,
                   "profile_refine")
    check_sdpa()
    check_refine_reference()
    vae_hires(models.vae, images)
    refined, targets, launches_r = stage2_phase(models, images, poses,
                                                contexts, gen)
    del refined
    rcfg3 = RenderConfig(d_max=S3_D_MAX)
    views = torch.tensor([24, 8, 16, 0], device=dev)  # front, back, sides
    info3 = check_kernels(g2, camera_from_c2w(
        orbit.c2w[views], orbit.fovy[views], HIRES, HIRES), rcfg3, gen,
        "stage3", timing=True)
    ts3, launches_3, _ = stage3_phase(g2, orbit, targets, gen)
    launches_t = turntable_phase(ts3.gaussians)
    with tempfile.TemporaryDirectory() as tmp:
        launches_rp = render_ply_phase(ts3.gaussians, tmp)

    # 8. animation of the final avatar: the command line at 1024^2, K1/K2
    # against their plain versions on its last re-posed frame, the bind at
    # the SMPL-X sizes, and the animation-space refine steps on the
    # SD1.5-width guidance
    with tempfile.TemporaryDirectory() as tmp:
        anim = animation_phase(ts3.gaussians, tmp)
        animator, launches_a = anim["animator"], anim["launches"]
        info_a = check_kernels(animator.gaussians, animator.orbit_camera(
            anim["azimuth"], height=HIRES, width=HIRES), rcfg3, gen,
            "animation", timing=True)
        bind_full_phase(anim["ply"], anim["motion"])
    launches_ar, _ = anim_refine_phase(guidance, anim["motion"], gen)

    # 9. the side systems on the final avatar: photo reconstruction of a
    # Blender-layout scene of it with K1/K2 against their plain versions on
    # the trained state (1 x 512^2), --export to a textured mesh, the viewer
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recon = photo_recon_phase(ts3.gaussians, tmp, gen)
        t_pr = time.perf_counter() - t0
        info_p = check_kernels(recon["gaussians"], recon["cams"],
                               RenderConfig(), gen, "photo_recon",
                               timing=True)
        t0 = time.perf_counter()
        launches_x = export_phase(ts3.gaussians, tmp)
        t_x = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches_v = viewer_phase(ts3.gaussians)
    log("side_systems", photo_recon_s=round(t_pr, 2), export_s=round(t_x, 2),
        viewer_s=round(time.perf_counter() - t0, 2))
    launches_p = recon["launches"]
    del recon

    # 10. the command line: stages 1 -> 2 -> 3 as a user runs them
    del guidance, models, run, lat, ctx, ctrl, contexts, images, poses, \
        targets, ts3, g2, anim, animator
    torch.cuda.empty_cache()
    cli = cli_phase()
    launches_cli = cli["launches"]
    torch.cuda.empty_cache()
    real = cli_real_phase()
    launches_real = real["launches"]
    torch.cuda.empty_cache()

    # 11. data parallel: two gloo ranks on the card through stages 1, 3 and
    # the refine against the single process, and one NCCL rank
    launches_dp = dp_phase(gs0, sk)

    # 12. the benchmark: python -m gaussianip_tpu_torch.bench_pipeline, its
    # stage 3 cut
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches_b = bench_phase(tmp)

    # 13. kernels line: K1/K2 timed at the stub-guided path's shapes, at
    # stage 3's and at photo reconstruction's (K1 also at an animation
    # frame's), launches on the guided
    # path and per path (launches_by_path; "cli": per stage of the command
    # line); K3 summed over the guided step's 67 launches and over a refine
    # denoise call's 67; "cli": each kernel against its plain version at
    # the command line's shapes
    by_path = {"stage1_stub": launches, "stage1_guided": launches_g,
               "handoff": launches_h, "stage2_refine": launches_r,
               "stage3": launches_3, "turntable": launches_t,
               "animation": launches_a, "anim_refine": launches_ar,
               "photo_recon": launches_p, "export": launches_x,
               "viewer": launches_v, "render_ply": launches_rp}
    by_stage = lambda launches_s, k: {stage: v[k]
                                      for stage, v in launches_s.items()}
    dp_launches = lambda k: {f"rank {r}": v[k]
                             for r, v in enumerate(launches_dp)}
    src = "gaussianip_tpu_torch/csrc/composite.cu"
    kernels = []
    for kind_, k, name, rep, err in (
            ("fwd", "K1", "K1 composite_fwd",
             "gaussianip_tpu/render/composite_pallas.py:221", "fwd_err"),
            ("bwd", "K2", "K2 composite_bwd (per-gaussian reduction fused)",
             "gaussianip_tpu/render/composite_pallas.py:246", "bwd_err")):
        b_ms, b_by = kernel_bound(info, kind_)
        b3_ms, b3_by = kernel_bound(info3, kind_)
        bp_ms, bp_by = kernel_bound(info_p, kind_)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches_g[k], "launches_by_path": {
                **{p: v[k] for p, v in by_path.items()},
                "cli": by_stage(launches_cli, k),
                "cli:real": by_stage(launches_real, k),
                "dp": dp_launches(k), "bench": by_stage(launches_b, k),
                "weight_parity": real["weight_parity"][k]},
            "max_abs_err": info[err],
            "ms": info[f"{kind_}_ms"], "plain_ms": info[f"{kind_}_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "first_bound_ms": kernel_bound(info, kind_, "first_ops")[0],
            "stage3": {
                "shape": f"4 x {HIRES}^2, d_max {S3_D_MAX}",
                "max_abs_err": info3[err], "ms": info3[f"{kind_}_ms"],
                "plain_ms": info3[f"{kind_}_plain_ms"], "bound_ms": b3_ms,
                "bound_by": b3_by, "library_ms": None},
            "photo_recon": {
                "shape": "1 x 512^2, d_max 25, SH degree 3",
                "pairs": info_p["pairs"], "max_abs_err": info_p[err],
                "ms": info_p[f"{kind_}_ms"],
                "plain_ms": info_p[f"{kind_}_plain_ms"], "bound_ms": bp_ms,
                "bound_by": bp_by, "library_ms": None},
            "cli": {tag: {"shape": c["shape"], "max_abs_err": c[err]}
                    for tag, c in cli["kernels"].items()}})
    ba_ms, ba_by = kernel_bound(info_a, "fwd")
    kernels[0]["animation"] = {
        "shape": f"1 x {HIRES}^2, d_max {S3_D_MAX}",
        "max_abs_err": info_a["fwd_err"], "ms": info_a["fwd_ms"],
        "plain_ms": info_a["fwd_plain_ms"], "bound_ms": ba_ms,
        "bound_by": ba_by, "library_ms": None}
    kernels.append({
        "name": "K3 conv3x3", "route": "cuda",
        "source": "gaussianip_tpu_torch/csrc/conv3x3.cu",
        "replaces": "gaussianip_tpu/ops/conv_pallas.py:78",
        "launches": launches_g["K3"], "launches_by_path": {
            **{p: v["K3"] for p, v in by_path.items()},
            "cli": by_stage(launches_cli, "K3"),
            "cli:real": by_stage(launches_real, "K3"),
            "dp": dp_launches("K3"), "bench": by_stage(launches_b, "K3"),
            "weight_parity": real["weight_parity"]["K3"]},
        "launches_by_variant": {
            "hopper": launches_g["K3_hopper"],
            "general": launches_g["K3_general"]},
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "prev_ms": k3["prev_ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "per": f"guided step ({K3_SITES} launches)",
        "replayed": "where the guidance denoise replays its CUDA graph "
                    "(64^2 latents or less on the card: stage1_guided, "
                    "anim_refine, cli, cli:real, dp), K3's launches are "
                    "the capture's count, added at each replay; "
                    "check_denoise_graph holds the device ops the "
                    "profiler lists in a replay equal to an eager call's",
        "replay_vs_eager_profiler": {
            k: dg[f"profiler_{k}"] for k in ("k3_eager", "k3_replay",
                                             "ops_eager", "ops_replay")},
        "stage2_refine": {
            "per": f"refine denoise call ({K3_SITES} launches, CFG batch 8 "
                   f"at {HIRES // 8}^2 latents)",
            "launches_by_variant": {
                "hopper": launches_r["K3_hopper"],
                "general": launches_r["K3_general"]},
            "max_abs_err": k3_r["max_abs_err"], "ms": k3_r["ms"],
            "prev_ms": k3_r["prev_ms"], "plain_ms": k3_r["plain_ms"],
            "bound_ms": k3_r["bound_ms"], "bound_by": k3_r["bound_by"],
            "library_ms": k3_r["library_ms"]},
        "cli": {
            "stage1": {"shape": "the tiny stack at 64^2 (VAE encode and its "
                                "backward, CFG batch 12), bf16 card vs f32 "
                                "CPU", "max_rel_err": guidance_errs},
            "stage2": {"shape": f"the tiny stack's refine, {REFINE_VIEWS} "
                                f"views at {CLI_STUB_SIZE}^2, 1 step, bf16 "
                                f"card vs f32 CPU",
                       "max_abs_err": cli["refine_err"]}}})
    kernels.append({
        "name": "K4 groupnorm (+ SiLU), fwd: stats + apply, bwd: stats + "
                "apply", "route": "cuda",
        "source": "gaussianip_tpu_torch/csrc/groupnorm.cu",
        "replaces": None,
        "per": "guided step (22 GroupNorms of the VAE encode, forward and "
               "backward)",
        **{k: round(v, 4) for k, v in k4["stage1_encode"].items()},
        "launches": {"fwd": launches_g["K4_fwd"],
                     "bwd": launches_g["K4_bwd"]},
        "stage2_refine": {
            "per": "refine chunk (encode of 2 views at 1024^2 and decode of "
                   "2 latents at 128^2, forward)",
            **{tag: {k: round(v, 4) for k, v in k4[tag].items()}
               for tag in ("refine_encode", "refine_decode")}}})
    kernels.append({
        "name": "K5 single-head attention, d = 512: fwd: stats + probs per "
                "view (P v on torch.mm), bwd: rowdot + grads per view (dV, "
                "dQ, dK on torch.mm)", "route": "cuda",
        "source": "gaussianip_tpu_torch/csrc/vae_attention.cu",
        "replaces": None,
        "per": f"guided step (the encode's mid attention, {BATCH} views of "
               f"{(RES // 8) ** 2} tokens, forward and backward)",
        **{k: round(v, 4) for k, v in k5["sd15_encode"]["bf16"].items()},
        "launches": {"fwd": launches_g["K5_fwd"],
                     "bwd": launches_g["K5_bwd"]},
        "sdxl_encode": {k: round(v, 4)
                        for k, v in k5["sdxl_encode"]["bf16"].items()},
        "stage2_refine": {
            "per": "refine chunk (2 views at 1024^2, the encode's or the "
                   "decode's attention, forward)",
            **{k: round(v, 4) for k, v in k5["refine_chunk"]["bf16"].items()}}})
    print(json.dumps({"kernels": kernels, "not_ported": []}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
