"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from the checkout (gaussianip_tpu_torch/csrc/: K1 and
K2, the compositor forward and backward with the per-gaussian gradient
reduction fused in, in composite.cu; K3, the 3x3 conv, in conv3x3.cu),
holds K1/K2 against their plain PyTorch versions at the stage-1 shapes (4
cameras, 512x512, capacity 524288, d_max=16) and times them, prints the
tiles' segment lengths, checks the tiled renderer against the
dense reference compositor, and drives stage-1
training with stub guidance at the recipe's sizes (configs/exp.yaml:
pts_num 100000, capacity 524288) with one densify and one prune at full
size. Then it builds the recipe's guidance stack at full SD1.5 width with
seeded random weights (system/pipeline.py:build_random_sd15_guidance),
holds K3 against its plain version at every distinct conv shape of the
guided step (batch 12, bf16) through the variant its gate names (the
Hopper wgmma + TMA one at every SD1.5 shape) and times it beside the
general variant and F.conv2d, and drives stage-1 training with the real
AHDS / ANPG guidance; the tiny test stack on the card runs the general
variant. Then, from the stub-trained, densified and pruned state, the rest
of the avatar path: the .ply handoff and the 32 refine views at 1024^2,
K3 against its plain version at every conv shape of a refine denoise call
(128^2 latents, CFG batch 8), the largest attention on a fused backend,
the tiny stack's refine on the card against the CPU, the VCR refinement
at 1024^2 (stage 2), K1/K2 against their plain versions at 1024^2 x 4,
stage-3 steps with a random-weight LPIPS at VGG16 width across the
densify, and the turntable. Prints one line per phase, a `kernels` JSON
line, the card's name and power limit, and as its last line {"ok": true,
"device": {...}}. Any failed phase exits non-zero; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

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
# the tiny guidance stack at bf16 on the card against float32 on the CPU,
# worst |diff| over the largest |value|: bf16 rounding through the stack's
# depth costs ~2% (the same comparison with bf16 on the CPU), a layout or
# indexing fault O(1)
GUIDANCE_REF_TOL = 6e-2
# f32 operations (an FMA counts 2) per (instance, pixel) pair up to the
# pixel's last contributor, as csrc/composite.cu computes the function with
# K1 at 2 and K2 at 4 pixels per thread. K1: the power from the column
# terms 4 (2 FMA), the column terms u, v 6 per thread and instance (3 FMA)
# over 2 pixels 3, exp 1, min 1, 1 - alpha 1, T update 1, weight 1, 5
# accumulations 10 -> 22. K2: power 4, column terms 6 / 4 = 1.5, exp 1,
# min 1, 1 - alpha 1, reciprocal 1, T 1, weight 1, feat . gout 9, dpower 4,
# r update 2, the sums of dpower, dpower y, dpower y^2 5, the 4 colour and
# depth terms 8, and per thread and instance the six coefficient terms
# from those sums 3 and the transposed reduction's adds 31 / 3 over 4
# pixels 3.3 -> 43
OPS_PER_PAIR = {"fwd": 22, "bwd": 43}
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
    from gaussianip_tpu_torch.render import composite_cuda as cc
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
    counters = (cc.composite_fwd_cuda, cc.composite_bwd_gaussians_cuda)
    launches = [c.launches for c in counters]

    def grads(cfg):
        leaves = {f: getattr(small, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        out = render(small.replace(**leaves), cams, bg, cfg)
        loss = ((out.rgb - tgt) ** 2).sum() + 0.1 * out.depth.sum()
        gr = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS])
        return out, dict(zip(PARAM_FIELDS, gr))

    o_t, g_t = grads(RenderConfig(d_max=16, depth_key="exact2",
                                  sort_stable=True))
    o_r, g_r = grads(RenderConfig(backend="reference"))
    ran = [c.launches - n0 for c, n0 in zip(counters, launches)]
    if ran != [1, 1]:
        raise AssertionError(f"oracle check launched K1, K2 {ran} times, "
                             f"want once each")
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
        k1_k2_launches=ran)


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
    order, as (module, input shape), from forward pre-hooks."""
    import torch
    from gaussianip_tpu_torch.ops.conv3x3 import Conv3x3

    sites, hooks = [], []
    for model in models:
        for m in model.modules():
            if isinstance(m, Conv3x3) and m.stride == 1:
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, args: sites.append((mod,
                                                    tuple(args[0].shape)))))
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
        counter = getattr(k3, f"conv3x3_{variant}")
        before = counter.launches
        y = k3.conv3x3_cuda(x, wp, bias)
        if counter.launches != before + 1:
            raise AssertionError(f"K3 {ci}->{co}: the {variant} variant "
                                 f"did not launch")
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
    before = {v: getattr(k3, f"conv3x3_{v}").launches
              for v in ("hopper", "general")}
    y = conv3x3(x, mod.weight.detach())
    g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
    y.backward(g)
    wt = mod.weight.detach().flip(2, 3).transpose(0, 1).to(torch.bfloat16)
    dxp = k3.conv3x3_plain(g, wt)
    torch.cuda.synchronize()
    dx_variant = k3.k3_variant(co, ci)
    dx_launches = {v: getattr(k3, f"conv3x3_{v}").launches - n
                   for v, n in before.items()}
    if dx_launches[dx_variant] != 1 + (k3.k3_variant(ci, co) == dx_variant):
        raise AssertionError(f"K3 dx did not run the {dx_variant} variant: "
                             f"{dx_launches}")
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


def check_guidance_reference(dev="cuda"):
    """The tiny guidance stack (system/pipeline.py:build_stub_guidance_stack)
    at bf16 on the card, every stride-1 conv through K3, against the same
    weights at float32 on the CPU, the path the CPU tests hold against the
    JAX package: the VAE latents of 4 renders at 64^2 and the gradient of a
    random projection of them to the renders, and one ControlNet + UNet
    pass on the 12-sample CFG batch."""
    import torch
    from gaussianip_tpu_torch.ops.conv3x3_cuda import (conv3x3_cuda,
                                                       conv3x3_general)
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
    launches = conv3x3_cuda.launches
    general = conv3x3_general.launches
    outs = []
    for guid, d in ((ref, "cpu"), (card, dev)):
        x = rgb.to(d, copy=True).requires_grad_(True)
        z = guid.encode_images(x, eps.to(d))
        (z * wz.to(d)).sum().backward()
        with torch.no_grad():
            e = guid.predict_noise(lat.to(d), ctrl.to(d), t.to(d),
                                   guid._context(view_aux(b, d), b))
        outs.append([v.detach().float().cpu().clone()
                     for v in (z, x.grad, e)])
    if conv3x3_cuda.launches == launches:
        raise AssertionError("the card's tiny stack did not run K3")
    if conv3x3_general.launches == general:
        raise AssertionError("the card's tiny stack did not run K3's "
                             "general variant")
    errs = {}
    for name, r, c in zip(("latents", "d_rgb", "denoise"), *outs):
        errs[name] = float((c - r).abs().max() / r.abs().max())
        if not errs[name] <= GUIDANCE_REF_TOL:
            raise AssertionError(f"guidance {name}: card bf16 vs CPU f32 "
                                 f"{errs[name]} > {GUIDANCE_REF_TOL}")
    log("guidance_reference", rel_err=errs, tol=GUIDANCE_REF_TOL,
        k3_general_launches=conv3x3_general.launches - general,
        k3_launches=conv3x3_cuda.launches - launches)


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


def train_phase(tag, gs0, sk, guidance, gen, cam_cfg, rcfg, n_steps: int,
                warmup: int, want: dict):
    """Stage-1 steps at the recipe's sizes from the state gs0: finite
    losses, parameters moved, and the launches of K1 ("fwd"), K2 ("bwd")
    and K3 ("conv3x3", and per variant "conv3x3_hopper",
    "conv3x3_general") counted from 0 in this run alone equal to `want`.
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
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    log(tag, steps=n_steps, loss_first=losses[0], loss_last=losses[-1],
        loss_sds=[round(x, 6) for x in sds], median_ms_per_step=med,
        step_ms=[round(x, 3) for x in step_ms], peak_gib=round(peak_gib, 3),
        launches=launches, moved=moved)
    return ts, cfg, launches, med


def kernel_counters():
    """name -> the launch counter of each kernel wrapper."""
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3
    from gaussianip_tpu_torch.render import composite_cuda as cc

    return {"fwd": cc.composite_fwd_cuda,
            "bwd": cc.composite_bwd_gaussians_cuda,
            "conv3x3": k3.conv3x3_cuda, "conv3x3_hopper": k3.conv3x3_hopper,
            "conv3x3_general": k3.conv3x3_general}


def count_launches(fn):
    """(fn()'s result, each kernel's launches counted from 0 in this call
    alone)."""
    import torch

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


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
    want = {"fwd": REFINE_VIEWS // 4, "bwd": 0, "conv3x3": 0,
            "conv3x3_hopper": 0, "conv3x3_general": 0}
    if launches != want:
        raise AssertionError(f"handoff: launches {launches} != {want}")
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


def check_refine_reference():
    """The tiny stack's refine_views (1 step, 32 views at 32^2: the VAE,
    anchors, keys and 6 dense groups, every stride-1 conv through K3) at
    bf16 on the card against the same weights at float32 on the CPU."""
    import torch
    from gaussianip_tpu_torch.guidance.prompts import fake_text_encoder
    from gaussianip_tpu_torch.system.pipeline import (
        build_stub_guidance_stack, refine_models)
    from gaussianip_tpu_torch.system.refine import (refine_contexts,
                                                    refine_views)

    r = REFINE_REF_RES
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
    if launches["conv3x3"] == 0 or launches["conv3x3_general"] == 0:
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
    want = {"fwd": 0, "bwd": 0, "conv3x3": K3_SITES * calls,
            "conv3x3_hopper": K3_SITES * calls, "conv3x3_general": 0}
    if launches != want:
        raise AssertionError(f"stage2_refine: launches {launches} != {want}")
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
    want = {"fwd": S3_STEPS, "bwd": S3_STEPS, "conv3x3": 0,
            "conv3x3_hopper": 0, "conv3x3_general": 0}
    if launches != want:
        raise AssertionError(f"stage3: launches {launches} != {want}")
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
    want = {"fwd": -(-n // 4), "bwd": 0, "conv3x3": 0, "conv3x3_hopper": 0,
            "conv3x3_general": 0}
    if launches != want:
        raise AssertionError(f"turntable: launches {launches} != {want}")
    log("turntable", frames=n, res=HIRES, total_ms=round(total_ms, 3),
        ms_per_frame=round(total_ms / n, 3), launches=launches)
    return launches


def kernel_bound(info, kind_, ops="ops"):
    """(bound ms, "bytes" or "operations") of K1 ("fwd") or K2 ("bwd") from
    check_kernels' counts."""
    t_bytes = info[f"{kind_}_bytes"] / PEAK_BYTES * 1e3
    t_ops = info[f"{kind_}_{ops}"] / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gaussianip_tpu_torch import _nvcc
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("device", name=repr(kind), smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    # 2. build
    t0 = time.perf_counter()
    libs = _nvcc.build(["composite", "conv3x3"])
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for name in ("composite", "conv3x3")
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
        WARMUP_STEPS, {"fwd": N_STEPS, "bwd": N_STEPS, "conv3x3": 0,
                       "conv3x3_hopper": 0, "conv3x3_general": 0})
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
    check_guidance_reference(dev)
    t0 = time.perf_counter()
    guidance = build_random_sd15_guidance(seed=SEED, device=dev)
    torch.cuda.synchronize()
    log("guidance_stack", seconds=round(time.perf_counter() - t0, 2),
        params_m={k: round(sum(p.numel() for p in m.parameters()) / 1e6, 3)
                  for k, m in guidance.models._asdict().items()})
    k3 = check_k3(conv_sites(guidance, gen, BATCH, RES, dev), gen, dev)
    ts_g, cfg_g, launches_g, med_g = train_phase(
        "stage1_guided", gs0, sk, guidance, gen, cam_cfg, rcfg, N_GUIDED,
        GUIDED_WARMUP, {"fwd": N_GUIDED, "bwd": N_GUIDED,
                        "conv3x3": K3_SITES * N_GUIDED,
                        "conv3x3_hopper": K3_SITES * N_GUIDED,
                        "conv3x3_general": 0})
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

    # 8. kernels line: K1/K2 timed at the stub-guided path's shapes and at
    # stage 3's, launches on the guided path and per path
    # (launches_by_path); K3 summed over the guided step's 67 launches and
    # over a refine denoise call's 67
    by_path = {"stage1_stub": launches, "stage1_guided": launches_g,
               "handoff": launches_h, "stage2_refine": launches_r,
               "stage3": launches_3, "turntable": launches_t}
    src = "gaussianip_tpu_torch/csrc/composite.cu"
    kernels = []
    for kind_, name, rep, err in (
            ("fwd", "K1 composite_fwd",
             "gaussianip_tpu/render/composite_pallas.py:221", "fwd_err"),
            ("bwd", "K2 composite_bwd (per-gaussian reduction fused)",
             "gaussianip_tpu/render/composite_pallas.py:246", "bwd_err")):
        b_ms, b_by = kernel_bound(info, kind_)
        b3_ms, b3_by = kernel_bound(info3, kind_)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches_g[kind_], "launches_by_path": {
                k: v[kind_] for k, v in by_path.items()},
            "max_abs_err": info[err],
            "ms": info[f"{kind_}_ms"], "plain_ms": info[f"{kind_}_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "first_bound_ms": kernel_bound(info, kind_, "first_ops")[0],
            "stage3": {
                "shape": f"4 x {HIRES}^2, d_max {S3_D_MAX}",
                "max_abs_err": info3[err], "ms": info3[f"{kind_}_ms"],
                "plain_ms": info3[f"{kind_}_plain_ms"], "bound_ms": b3_ms,
                "bound_by": b3_by, "library_ms": None}})
    kernels.append({
        "name": "K3 conv3x3", "route": "cuda",
        "source": "gaussianip_tpu_torch/csrc/conv3x3.cu",
        "replaces": "gaussianip_tpu/ops/conv_pallas.py:78",
        "launches": launches_g["conv3x3"], "launches_by_path": {
            k: v["conv3x3"] for k, v in by_path.items()},
        "launches_by_variant": {
            "hopper": launches_g["conv3x3_hopper"],
            "general": launches_g["conv3x3_general"]},
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "prev_ms": k3["prev_ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "per": f"guided step ({K3_SITES} launches)",
        "stage2_refine": {
            "per": f"refine denoise call ({K3_SITES} launches, CFG batch 8 "
                   f"at {HIRES // 8}^2 latents)",
            "launches_by_variant": {
                "hopper": launches_r["conv3x3_hopper"],
                "general": launches_r["conv3x3_general"]},
            "max_abs_err": k3_r["max_abs_err"], "ms": k3_r["ms"],
            "prev_ms": k3_r["prev_ms"], "plain_ms": k3_r["plain_ms"],
            "bound_ms": k3_r["bound_ms"], "bound_by": k3_r["bound_by"],
            "library_ms": k3_r["library_ms"]}})
    print(json.dumps({"kernels": kernels, "not_ported": []}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
