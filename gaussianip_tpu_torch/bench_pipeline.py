"""Wall clock of one avatar on the card, stage by stage (port of
scripts/bench_pipeline.py, with bench.py's render metrics and
bench_unet.py's denoise rate in the same process):

  python -m gaussianip_tpu_torch.bench_pipeline [123] [--device cuda]
      [--out PIPELINE_BENCH_TORCH.json] [--stage3-steps 800] [--commit ID]

The positional argument picks the stages (default all three). The avatar
is the JAX script's: the synthetic SMPL-X body (make_test_model on numpy
default_rng(0), 2000 vertices, 3000 faces, scaled by -10), 100,000
sampled points of colour 0.5 at capacity 1 << 17.

  stage 1  the guided train step (build_random_sd15_guidance(seed=42), bf16,
           4 x 512^2, d_max 16): the first step, 8 warm-up steps, then 20
           steps with a host sync after each; 2400 steps projected from
           their mean.
  stage 2  refine_views twice on 32 random views and pose maps at 1024^2
           with zero [2, 81, 768] contexts: the first call (cuDNN's and
           cuBLAS's first use included) and the second, the wall kept.
  stage 3  train_stage3 from the avatar, every step (800 by default, the
           densify included) at 4 x 1024^2 against random [32, 415, 290, 3]
           targets with build_random_lpips(seed=42).

Then bench.py's metrics on its capsule scene (100,000 points, one camera
at 1024^2): the forward and the forward + backward render (the tiles
backend, so K1 and K2), the live instances, the stage-1 render at 4 x
512^2 (d_max 16), and K1's and K2's ms a launch beside their bound; and
bench_unet.py's metric: one ControlNet + UNet call of the guidance stack
at CFG batch 12, 64^2 latents. Every time is CUDA events around calls on
the card (`torch.cuda.Event`, the mean over the timed calls after
warm-up), or the host clock to a synchronise for a whole loop, in place
of the JAX scripts' chained calls.

Prints one JSON line: the device and its power limit, the commit, the
stages and the steps each ran, each kernel's launches per stage and the
times. With all three stages it also writes the line to --out; it never
writes PIPELINE_BENCH.json, the JAX package's TPU record. `--device cpu`
runs the same on the CPU (the kernels' plain versions); the default,
cuda, raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

import gaussianip_tpu_torch as gt

from .kernels import count_launches

N_POINTS = 100_000
CAPACITY = 1 << 17  # scripts/bench_pipeline.py
SEED = 42
STAGE1_STEPS = 2400
STAGE1_WARMUP = 8
STAGE1_TIMED = 20
STAGE1_RES = 512
STAGE1_BATCH = 4
STAGE3_STEPS = 800
HIRES = 1024
TIMED_CALLS = 10  # per render and denoise metric, after 2 warm-up calls
REFERENCE_MIN = 40.0  # the reference's ~40 min per avatar (its README)
# K1/K2's bound, as PERF.md counts it: f32 operations per (instance,
# pixel) pair up to the pixel's last contributor (csrc/composite.cu), K2's
# fused epilogue per instance up to its tile's last contributor, the bytes
# each reads once and writes once, against an H100's published peaks
OPS_PER_PAIR = {"k1": 23, "k2": 44}
EPILOGUE_OPS = 37
BYTES_PER_INSTANCE = 64
EPILOGUE_BYTES = 8 + 24 + 40
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


# --------------------------------------------------------------- scenes


def avatar(device, rng: np.random.Generator, n: int = N_POINTS,
           capacity: int = CAPACITY):
    """(skeleton, state): the JAX script's avatar; `rng` draws the body."""
    from .human.skeleton import Skeleton
    from .human.smplx import make_test_model
    from .model.gaussians import create_from_pcd
    from .ops.knn import mean_dist2_3nn

    sk = Skeleton(_test_model=make_test_model(rng, n_verts=2000,
                                              n_faces=3000, device=device))
    sk.forward_smplx()
    sk.scale(-10)
    pts = sk.sample_smplx_points(n)
    gs = create_from_pcd(pts, np.full((n, 3), 0.5, np.float32), capacity,
                         mean_dist2_3nn(torch.as_tensor(pts, device=device)),
                         device=device)
    return sk, gs


def capsule_points(n: int = N_POINTS, seed: int = 0):
    """bench.py's scene as numpy: (points, colours, opacity logits), points
    on a capsule with noise."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-0.85, 0.85, n)
    th = rng.uniform(0, 2 * np.pi, n)
    r = 0.25 * np.sqrt(np.maximum(0.0, 1 - (z / 0.9) ** 2)) + 0.03
    pts = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1.0, 2.5, (n, 1)).astype(np.float32)
    return pts, cols, opacity


def capsule_scene(device, n: int = N_POINTS):
    """bench.py's state: the capsule at capacity n, its opacities."""
    from .model.gaussians import create_from_pcd
    from .ops.knn import mean_dist2_3nn

    pts, cols, opacity = capsule_points(n)
    d2 = mean_dist2_3nn(torch.as_tensor(pts, device=device), block=4096)
    gs = create_from_pcd(pts, cols, n, d2, device=device)
    return gs.replace(opacity=torch.as_tensor(opacity, device=device))


def orbit_cameras(n: int, radius: float, z: float, res: int, device):
    """bench.py's cameras: n azimuths over the circle at `radius`, height
    z, looking at the origin, fovy 1 rad."""
    from .data.cameras import camera_from_c2w
    from .ops.camera_math import look_at_c2w

    az = torch.arange(n, dtype=torch.float32, device=device) * (
        2 * np.pi / n)
    eye = torch.stack([radius * torch.cos(az), radius * torch.sin(az),
                       torch.full((n,), z, device=device)], -1)
    up = torch.tensor([[0.0, 0, 1]], device=device).expand(n, 3)
    c2w = look_at_c2w(eye, torch.zeros((n, 3), device=device), up)
    return camera_from_c2w(c2w, torch.ones(n, device=device), res, res)


# --------------------------------------------------------------- timing


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mean_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn over `iters` calls after `warmup`: CUDA events on the
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# --------------------------------------------------------------- stages


def bench_stage1(gs, sk, guidance, res: int = STAGE1_RES,
                 batch: int = STAGE1_BATCH, warmup: int = STAGE1_WARMUP,
                 steps: int = STAGE1_TIMED, seed: int = 1) -> dict:
    """The guided stage-1 step: the first, `warmup` more, then `steps`
    each ended by a host sync (the loss read back)."""
    from .data.sampler import CameraSamplerConfig
    from .model.adam import AdamHyper
    from .render.render import RenderConfig
    from .system.stage1 import Stage1Config, init_train_state, \
        make_train_step

    dev = gs.device
    step_fn = make_train_step(
        Stage1Config(render_height=res, render_width=res),
        CameraSamplerConfig(height=res, width=res, batch_size=batch),
        RenderConfig(d_max=16), AdamHyper(), guidance, sk.points3d)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run():
        ts = init_train_state(gs)
        t0 = time.perf_counter()
        ts, m = step_fn(ts, gen)
        float(m["loss"])
        first = time.perf_counter() - t0
        for _ in range(warmup):
            ts, m = step_fn(ts, gen)
        float(m["loss"])
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            ts, m = step_fn(ts, gen)
            losses.append(float(m["loss"]))
        return first, (time.perf_counter() - t0) / steps * 1e3, losses

    (first, step_ms, losses), launches = count_launches(run, dev)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"stage 1: non-finite loss {losses}")
    return {"stage1_first_step_s": first, "stage1_step_ms": step_ms,
            "stage1_2400_steps_min": step_ms * STAGE1_STEPS / 6e4,
            "stage1_steps": 1 + warmup + steps, "stage1_res": res,
            "stage1_batch": batch, "stage1_loss_last": losses[-1],
            "launches_stage1": launches}


def bench_stage2(models, images, controls, contexts: dict, noise) -> dict:
    """refine_views twice on the same inputs: the first call's wall and the
    second's."""
    from .system.refine import crop_and_downsample, refine_views

    dev = images.device
    walls = []

    def run():
        for _ in range(2):
            sync(dev)
            t0 = time.perf_counter()
            out = refine_views(models, images, controls, contexts, noise)
            sync(dev)
            walls.append(time.perf_counter() - t0)
        return out

    refined, launches = count_launches(run, dev)
    if not bool(torch.isfinite(refined).all()):
        raise RuntimeError("stage 2: non-finite refined views")
    targets = crop_and_downsample(refined)
    return {"stage2_total_s_incl_compile": walls[0],
            "stage2_wall_s": walls[1], "stage2_calls": 2,
            "stage2_res": images.shape[1],
            "stage2_targets": list(targets.shape),
            "launches_stage2": launches}


def bench_stage3(gs, lpips, targets, res: int = HIRES,
                 steps: int = STAGE3_STEPS, seed: int = 11,
                 crop: dict | None = None) -> dict:
    """train_stage3 for `steps` steps from the avatar (Stage3Config's
    recipe: refine start 2400, the densify at 2500) on the refine orbit of
    32 views at `res`, against `targets` [32, h, w, 3] (the crop, default
    the recipe's {"crop_y": .., "crop_x": ..} at 1024^2, halved)."""
    from .data.sampler import refine_orbit_batch
    from .model.adam import AdamHyper
    from .render.render import RenderConfig
    from .system.stage1 import init_train_state
    from .system.stage3 import Stage3Config, draw_view_ids, train_stage3

    dev = gs.device
    cfg = Stage3Config(height=res, width=res, refine_start_step=2400,
                       max_steps=STAGE3_STEPS, **(crop or {}))
    orbit = refine_orbit_batch(32, 0.0, 1.8, 40.0, res, res, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = draw_view_ids(gen, 32, cfg.train_bs, steps, dev)
    noise = torch.randn((2, gs.capacity, 3), generator=gen, device=dev)
    losses = []

    def run():
        ts = init_train_state(gs)
        sync(dev)
        t0 = time.perf_counter()
        ts = train_stage3(ts, cfg, RenderConfig(), AdamHyper(), orbit,
                          targets, ids, noise, lpips_fn=lpips,
                          log_every=max(steps - 1, 1),
                          log_fn=lambda i, m: losses.append(m["loss"]))
        sync(dev)
        return ts, time.perf_counter() - t0

    (ts, wall), launches = count_launches(run, dev)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"stage 3: non-finite loss {losses}")
    return {"stage3_wall_s": wall, "stage3_steps": steps,
            "stage3_res": res, "stage3_n_active": ts.gaussians.n_active,
            "stage3_loss_last": losses[-1], "launches_stage3": launches}


# --------------------------------------------------------------- bench.py


def _kernels_on(gs, cams, cfg, iters: int) -> dict:
    """K1's and K2's ms a launch on one camera batch beside their bound:
    the kernels on the card, their plain versions on the CPU."""
    from .render import composite_cuda as cc
    from .render.render import instance_data

    inst = instance_data(gs, cams, cfg)
    bn, data = inst.binning, inst.data
    starts, counts = bn.starts, bn.counts
    dev = data.device
    if data.is_cuda:
        order = cc.heaviest_first(counts)
        fwd = lambda: cc.composite_fwd_cuda(data, starts, counts, order)
        out = fwd()
        bwd = lambda: cc.composite_bwd_gaussians_cuda(
            data, inst.packed, bn.gidx, starts, counts, order, out, gout,
            inst.n_tiles_x)
    else:
        fwd = lambda: cc.composite_fwd_plain(data, starts, counts)
        out = fwd()
        bwd = lambda: cc.composite_bwd_gaussians_plain(
            data, inst.packed, bn.gidx, bn.tile_of, starts, counts, out,
            gout, inst.n_tiles_x, inst.n_tiles_y)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    gout[:, :, 5:] = 0.0  # as the render path's
    last = out[:, :, 5].to(torch.int64)
    pairs = int((last + 1).sum())
    touched = int((last.amax(dim=-1) + 1).sum())
    live = int(counts.to(torch.int64).sum())
    out_bytes = counts.numel() * 8 * 256 * 4
    ops = {"k1": pairs * OPS_PER_PAIR["k1"],
           "k2": pairs * OPS_PER_PAIR["k2"] + touched * EPILOGUE_OPS}
    nbytes = {"k1": live * BYTES_PER_INSTANCE + out_bytes,
              "k2": touched * (BYTES_PER_INSTANCE + EPILOGUE_BYTES)
              + 2 * out_bytes}
    res = {"pairs": pairs}
    for k, fn in (("k1", fwd), ("k2", bwd)):
        ms = mean_ms(fn, dev, iters)
        t_ops = ops[k] / PEAK_F32_OPS * 1e3
        t_bytes = nbytes[k] / PEAK_BYTES * 1e3
        res[f"{k}_ms"] = ms
        res[f"{k}_bound_ms"] = max(t_ops, t_bytes)
        res[f"{k}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        res[f"{k}_share_of_bound"] = res[f"{k}_bound_ms"] / ms
    return res


def bench_render(gs, res: int = HIRES, train_res: int = STAGE1_RES,
                 iters: int = TIMED_CALLS) -> dict:
    """bench.py's render metrics on `gs` (its capsule scene): one camera at
    res^2 (radius 1.8, z 0.2), the forward and the forward + backward of
    sum(rgb^2) + sum(alpha) + sum(depth) to every parameter and the 2D
    offset; the stage-1 shape, 4 x train_res^2 at radius 1.5, z 0.1,
    d_max 16, forward + backward of sum(rgb^2) + sum(alpha); the live
    instances and K1/K2 on the first camera."""
    from .model.gaussians import PARAM_FIELDS
    from .render.render import RenderConfig, count_live_instances, render

    dev = gs.device
    cams = orbit_cameras(1, 1.8, 0.2, res, dev)
    cams2 = orbit_cameras(4, 1.5, 0.1, train_res, dev)
    bg = torch.zeros(3, device=dev)
    cfg, cfg2 = RenderConfig(), RenderConfig(d_max=16)

    def fwd():
        with torch.no_grad():
            return render(gs, cams, bg, cfg).rgb

    def fwd_bwd(cameras, rcfg, depth: bool):
        leaves = {f: getattr(gs, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        off = torch.zeros((cameras.batch, gs.capacity, 2), device=dev,
                          requires_grad=True)
        out = render(gs.replace(**leaves), cameras, bg, rcfg,
                     mean2d_offset=off)
        loss = (out.rgb ** 2).sum() + out.alpha.sum()
        if depth:
            loss = loss + out.depth.sum()
        return torch.autograd.grad(loss, [*leaves.values(), off])

    def run():
        r = {"fwd_ms": mean_ms(fwd, dev, iters),
             "fwd_bwd_ms": mean_ms(lambda: fwd_bwd(cams, cfg, True), dev,
                                   iters),
             "train_step_render_512_b4_ms": mean_ms(
                 lambda: fwd_bwd(cams2, cfg2, False), dev, iters)}
        r["n_live_instances"] = int(count_live_instances(gs, cams, cfg)[0])
        r.update(_kernels_on(gs, cams, cfg, iters))
        return r

    r, launches = count_launches(run, dev)
    r["splat_render_fwd_bwd_1024px_100k"] = 1e3 / r["fwd_bwd_ms"]
    r["render_res"] = res
    r["launches_render"] = launches
    return r


def bench_denoise(guidance, batch: int = 3 * STAGE1_BATCH,
                  iters: int = TIMED_CALLS) -> dict:
    """bench_unet.py's metric: one ControlNet + UNet call of the guidance
    stack (predict_noise, no grad) at CFG batch `batch` and the stack's
    latent size, timestep 500, zero context and pose maps."""
    vae = guidance.models.vae
    size = guidance.cfg.image_size
    s = size // vae.cfg.downscale
    dev = next(guidance.models.unet.parameters()).device
    unet_cfg = guidance.models.unet.cfg
    n_ctx = 77 + unet_cfg.ip_tokens
    lat = torch.zeros((batch, vae.cfg.latent_channels, s, s), device=dev)
    control = torch.zeros((batch, 3, size, size), device=dev)
    t = torch.full((batch,), 500, dtype=torch.int64, device=dev)
    ctx = torch.zeros((batch, n_ctx, unet_cfg.cross_attention_dim),
                      device=dev)

    def call():
        with torch.no_grad():
            return guidance.predict_noise(lat, control, t, ctx)

    ms, launches = count_launches(lambda: mean_ms(call, dev, iters), dev)
    return {"unet_denoise_ms": ms, "unet_denoise_steps_per_s": 1e3 / ms,
            "unet_denoise_batch": batch, "unet_denoise_latent": s,
            "launches_denoise": launches}


# --------------------------------------------------------------- main


def device_info(device) -> dict:
    """The device's name, count and (on the card) power limit."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.split()
        info["power_limit"] = " ".join(smi[:2])
    except (OSError, subprocess.CalledProcessError):
        info["power_limit"] = None
    return info


def commit_of(path: str) -> str | None:
    """HEAD of the checkout at `path` (with "+dirty" when tracked files
    differ from it), or None outside a git checkout."""
    try:
        head = subprocess.run(["git", "-C", path, "rev-parse", "HEAD"],
                              capture_output=True, text=True, check=True)
        dirty = subprocess.run(
            ["git", "-C", path, "status", "--porcelain", "-uno"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    return head.stdout.strip() + ("+dirty" if dirty else "")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stages", nargs="?", default="123",
                   help="the stages to run, as digits (default 123)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default="PIPELINE_BENCH_TORCH.json",
                   help="where a run of all three stages writes its line")
    p.add_argument("--stage3-steps", type=int, default=STAGE3_STEPS,
                   help=f"stage-3 steps to run (default {STAGE3_STEPS}; "
                        f"fewer cut the run, and the line says so)")
    p.add_argument("--commit", default=None,
                   help="the commit to record where the checkout has no "
                        "git metadata (default: git's HEAD)")
    args = p.parse_args(argv)
    if not set(args.stages) <= set("123") or not args.stages:
        p.error(f"stages {args.stages!r}: digits of 123")
    if os.path.basename(os.path.abspath(args.out)) == "PIPELINE_BENCH.json":
        p.error("PIPELINE_BENCH.json is the JAX package's TPU record")
    return args


def main(argv=None) -> dict:
    """Runs the bench; returns the line it prints."""
    args = parse_args(argv)
    from .launch import _check_args

    _check_args(args)
    dev = args.device
    which = set(args.stages)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    policy = gt.set_precision_policy()
    if dev == "cuda":  # nvcc's time is not a step's
        from . import _nvcc

        _nvcc.build(["composite", "conv3x3"])
    from .system import refine
    from .system.pipeline import build_random_lpips, \
        build_random_sd15_guidance, refine_models
    from .system.refine import VIEW_NAME_ALL

    line = {"bench": "pipeline", "device": device_info(dev),
            "commit": args.commit or commit_of(repo),
            "torch": torch.__version__, "precision_policy": policy,
            "stages": "".join(sorted(which)), "capacity": CAPACITY,
            "n_points": N_POINTS, "weights": "random bf16 (seed 42)"}
    rng = np.random.default_rng(0)
    sk, gs = avatar(dev, rng, N_POINTS, CAPACITY)
    guidance = build_random_sd15_guidance(seed=SEED, device=dev)
    if "1" in which:
        line.update(bench_stage1(gs, sk, guidance, STAGE1_RES, STAGE1_BATCH,
                                 STAGE1_WARMUP, STAGE1_TIMED))
        gt.info(f"stage1: {line['stage1_step_ms']:.1f} ms/step")
    if "2" in which:
        shape = (32, HIRES, HIRES, 3)
        images = torch.as_tensor(rng.random(shape, np.float32), device=dev)
        controls = torch.as_tensor(rng.random(shape, np.float32), device=dev)
        width = guidance.models.unet.cfg.cross_attention_dim
        zero = torch.zeros((2, 77 + guidance.models.unet.cfg.ip_tokens,
                            width), device=dev)
        s = HIRES // guidance.models.vae.cfg.downscale
        gen = torch.Generator(device=dev).manual_seed(2)
        noise = torch.randn((4, s, s), generator=gen, device=dev)
        line.update(bench_stage2(refine_models(guidance), images, controls,
                                 {n: zero for n in VIEW_NAME_ALL}, noise))
        del images, controls
        gt.info(f"stage2: {line['stage2_wall_s']:.1f} s")
    if "3" in which:
        cy, cx = refine.CROP_Y, refine.CROP_X
        targets = torch.as_tensor(rng.random(
            (32, (cy[1] - cy[0]) // 2, (cx[1] - cx[0]) // 2, 3), np.float32),
            device=dev)
        line.update(bench_stage3(gs, build_random_lpips(SEED, dev), targets,
                                 HIRES, args.stage3_steps,
                                 crop={"crop_y": cy, "crop_x": cx}))
        gt.info(f"stage3: {line['stage3_wall_s']:.1f} s")
    line.update(bench_denoise(guidance, 3 * STAGE1_BATCH, TIMED_CALLS))
    del guidance, gs
    if dev == "cuda":
        torch.cuda.empty_cache()
    line.update(bench_render(capsule_scene(dev, N_POINTS), HIRES,
                             STAGE1_RES, TIMED_CALLS))
    if which == set("123"):
        s3_min = line["stage3_wall_s"] / 60 * STAGE3_STEPS / line[
            "stage3_steps"]
        total = (line["stage1_2400_steps_min"] + line["stage2_wall_s"] / 60
                 + s3_min)
        line["pipeline_total_min"] = total
        line["vs_reference_40min"] = REFERENCE_MIN / total
    line["cut"] = {"stage1": f"{line.get('stage1_steps', 0)} of "
                             f"{STAGE1_STEPS} steps run, the rest projected",
                   "stage3": f"{line.get('stage3_steps', 0)} of "
                             f"{STAGE3_STEPS} steps"}
    print(json.dumps(line), flush=True)
    if which == set("123"):
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
            f.write("\n")
    return line


if __name__ == "__main__":
    main()
