"""Vanilla 3DGS photo reconstruction of COLMAP / Blender scenes (port of
gaussianip_tpu/system/photo_recon.py).

Per step: render one training view, loss (1 - lambda) * L1 + lambda *
(1 - SSIM) with lambda_dssim 0.2, backward (the compositor's backward is
K2 on the card), viewspace-gradient densify statistics, Adam with the
position LR scaled by the scene radius. The host loop raises the SH degree
every 1000 iterations, densifies every 100 in [500, 15000) at gradient
threshold 2e-4 (the world-size prune only after the first opacity reset)
and resets the opacities every 3000. `evaluate` gives PSNR / SSIM (/
LPIPS) over a scene's views, one view at a time.

The step draws its view ids from a torch.Generator and hands them to the
inner step (`make_inner_step`), which a test can call with injected ids;
the densify's split noise comes from the same generator. Images are
decoded once up front on the host."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..data.cameras import camera_from_c2w
from ..data.scene_readers import SceneInfo, image_size
from ..model.adam import AdamHyper, adam_step
from ..model.densify import add_stats, densify_and_prune, reset_opacity
from ..model.gaussians import PARAM_FIELDS, create_from_pcd
from ..ops.knn import mean_dist2_3nn
from ..render.render import RenderConfig, render
from ..utils.metrics import l1 as l1_fn
from ..utils.metrics import psnr, ssim
from ..utils.saving import read_png
from .stage1 import TrainState, init_train_state

N_RANDOM_POINTS = 100_000  # a scene without points (Blender): random init


@dataclass(frozen=True)
class PhotoReconConfig:
    iterations: int = 7000
    resolution: int = 512
    batch_size: int = 1
    sh_degree: int = 3
    lambda_dssim: float = 0.2
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densification_interval: int = 100
    densify_grad_threshold: float = 2e-4
    opacity_reset_interval: int = 3000
    percent_dense: float = 0.01
    white_background: bool = False
    capacity: int = 1 << 19


def _read_image(path: str, res: int) -> np.ndarray:
    """[res, res, 3] float32 in [0, 1]: alpha dropped (not composited),
    as PIL's convert("RGB") drops it. An 8-bit PNG already at `res` is
    decoded by the port's own reader; any other size or format is resized
    by PIL (bicubic, PIL's default)."""
    w, h = image_size(path)
    if (w, h) == (res, res):
        try:
            return read_png(path).astype(np.float32) / 255.0
        except ValueError:  # not an 8-bit PNG: PIL reads it
            pass
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path} ({w}x{h}) needs PIL to be read at {res}x{res}: only "
            f"8-bit PNGs at the training resolution are read without "
            f"it") from e
    with Image.open(path) as im:
        im = im.convert("RGB").resize((res, res))
        return np.asarray(im, np.float32) / 255.0


def _load_images(scene: SceneInfo, res: int) -> np.ndarray:
    """[V, res, res, 3] float32; a missing file gives a zero image."""
    return np.stack([
        _read_image(cam.image_path, res) if os.path.exists(cam.image_path)
        else np.zeros((res, res, 3), np.float32) for cam in scene.cameras])


def init_from_scene(scene: SceneInfo, cfg: PhotoReconConfig, seed: int = 0,
                    device="cuda") -> TrainState:
    """The scene's points, or N_RANDOM_POINTS uniform in [-1.3, 1.3]^3 with
    random colours from np.random.default_rng(seed) (the JAX package's
    draws, bit for bit); capacity max(cfg.capacity, 2 N)."""
    if scene.points is not None:
        pts = np.asarray(scene.points, np.float32)
        cols = np.asarray(scene.colors, np.float32)
    else:
        rng = np.random.default_rng(seed)
        pts = rng.random((N_RANDOM_POINTS, 3), dtype=np.float32) * 2.6 - 1.3
        cols = rng.random((N_RANDOM_POINTS, 3), dtype=np.float32)
    d2 = mean_dist2_3nn(torch.as_tensor(pts, device=device))
    gs = create_from_pcd(pts, cols, max(cfg.capacity, 2 * len(pts)), d2,
                         max_sh_degree=cfg.sh_degree, device=device)
    return init_train_state(gs)


def make_inner_step(cfg: PhotoReconConfig, render_cfg: RenderConfig,
                    adam_hyper: AdamHyper, c2ws: torch.Tensor,
                    fovys: torch.Tensor, images: torch.Tensor,
                    active_sh_degree: int):
    """`inner(ts, ids) -> (ts, metrics)`: one step on the views `ids` [B]
    of c2ws [V, 4, 4], fovys [V] and images [V, res, res, 3]."""
    res = cfg.resolution

    def inner(ts: TrainState, ids: torch.Tensor):
        g = ts.gaussians
        bg = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                        device=g.device)
        cams = camera_from_c2w(c2ws[ids], fovys[ids], res, res)
        tgt = images[ids]
        leaves = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        offset = torch.zeros((ids.shape[0], g.capacity, 2), device=g.device,
                             requires_grad=True)
        out = render(g.replace(**leaves), cams, bg, render_cfg,
                     mean2d_offset=offset, active_sh_degree=active_sh_degree)
        ll1 = l1_fn(out.rgb, tgt)
        loss = ((1 - cfg.lambda_dssim) * ll1
                + cfg.lambda_dssim * (1.0 - ssim(out.rgb, tgt)))
        grads = torch.autograd.grad(
            loss, [leaves[f] for f in PARAM_FIELDS] + [offset])
        with torch.no_grad():
            stats = add_stats(ts.stats, grads[-1].sum(dim=0),
                              out.radii.amax(dim=0),
                              (out.radii > 0).any(dim=0))
            new_g, new_opt = adam_step(g, dict(zip(PARAM_FIELDS, grads[:-1])),
                                       ts.opt, adam_hyper, ts.step)
            metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                       "psnr": psnr(out.rgb, tgt), "n_active": new_g.n_active}
        return TrainState(new_g, new_opt, stats, ts.step + 1), metrics

    return inner


def make_recon_step(cfg: PhotoReconConfig, render_cfg: RenderConfig,
                    adam_hyper: AdamHyper, c2ws: torch.Tensor,
                    fovys: torch.Tensor, images: torch.Tensor,
                    active_sh_degree: int):
    """`step(ts, generator) -> (ts, metrics)`: draws batch_size distinct
    view ids (randperm(V)[:B]) from `generator` and runs the inner step."""
    inner = make_inner_step(cfg, render_cfg, adam_hyper, c2ws, fovys, images,
                            active_sh_degree)
    n_views = images.shape[0]

    def step(ts: TrainState, generator: torch.Generator):
        ids = torch.randperm(n_views, generator=generator,
                             device=generator.device)[:cfg.batch_size]
        return inner(ts, ids)

    return step


def scene_tensors(scene: SceneInfo, device):
    """(c2ws [V, 4, 4], fovys [V]) of a scene's cameras on `device`."""
    c2ws = torch.as_tensor(np.stack([c.c2w for c in scene.cameras]),
                           dtype=torch.float32, device=device)
    fovys = torch.tensor([c.fovy for c in scene.cameras],
                         dtype=torch.float32, device=device)
    return c2ws, fovys


def train_photo_recon(scene: SceneInfo,
                      cfg: PhotoReconConfig = PhotoReconConfig(),
                      render_cfg: RenderConfig = RenderConfig(),
                      seed: int = 0, images: Optional[np.ndarray] = None,
                      log_every: int = 500,
                      log_fn: Optional[Callable[[int, dict], None]] = None,
                      device="cuda") -> TrainState:
    """The host schedule loop. A torch.Generator on `device` seeded with
    `seed` draws the view ids and the densify's split noise; metrics reach
    `log_fn` as host floats."""
    ts = init_from_scene(scene, cfg, seed, device)
    if images is None:
        images = _load_images(scene, cfg.resolution)
    images = torch.tensor(np.asarray(images, np.float32), device=device)
    c2ws, fovys = scene_tensors(scene, device)
    radius = scene.nerf_normalization_radius
    hyper = AdamHyper(spatial_lr_scale=radius)
    generator = torch.Generator(device=device).manual_seed(seed)
    active_deg = 0
    step_fn = make_recon_step(cfg, render_cfg, hyper, c2ws, fovys, images,
                              active_deg)
    for i in range(cfg.iterations):
        if i and i % 1000 == 0 and active_deg < cfg.sh_degree:
            active_deg += 1  # the reference's oneupSHdegree
            step_fn = make_recon_step(cfg, render_cfg, hyper, c2ws, fovys,
                                      images, active_deg)
        ts, metrics = step_fn(ts, generator)
        if (cfg.densify_from_iter <= i < cfg.densify_until_iter
                and i % cfg.densification_interval == 0 and i > 0):
            # the world-size prune (0.1 x radius) only after the first
            # opacity reset; min opacity 0.005
            world = (0.1 * radius if i > cfg.opacity_reset_interval
                     else 1e9)
            noise = torch.randn((2, ts.gaussians.capacity, 3),
                                generator=generator, device=device)
            g, opt, stats, _ = densify_and_prune(
                ts.gaussians, ts.opt, ts.stats, noise,
                max_grad=cfg.densify_grad_threshold, min_opacity=0.005,
                extent=radius, max_world_size=world,
                percent_dense=cfg.percent_dense)
            ts = TrainState(g, opt, stats, ts.step)
        if i > 0 and i % cfg.opacity_reset_interval == 0:
            g, opt = reset_opacity(ts.gaussians, ts.opt)
            ts = TrainState(g, opt, ts.stats, ts.step)
        if log_fn is not None and i % log_every == 0:
            log_fn(i, {k: float(v) for k, v in metrics.items()})
    return ts


@torch.no_grad()
def evaluate(ts: TrainState, scene: SceneInfo, cfg: PhotoReconConfig,
             render_cfg: RenderConfig = RenderConfig(), images=None,
             lpips_fn=None) -> dict:
    """Mean PSNR / SSIM (/ LPIPS with `lpips_fn(x, y) -> [B]`) over the
    scene's views, one view at a time, at the state's active SH degree."""
    if images is None:
        images = _load_images(scene, cfg.resolution)
    g = ts.gaussians
    res = cfg.resolution
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                    device=g.device)
    c2ws, fovys = scene_tensors(scene, g.device)
    out_psnr, out_ssim, out_lpips = [], [], []
    for i in range(len(scene.cameras)):
        cams = camera_from_c2w(c2ws[i:i + 1], fovys[i:i + 1], res, res)
        rgb = render(g, cams, bg, render_cfg).rgb
        tgt = torch.tensor(np.asarray(images[i], np.float32),
                           device=g.device)[None]
        out_psnr.append(float(psnr(rgb, tgt)))
        out_ssim.append(float(ssim(rgb, tgt)))
        if lpips_fn is not None:
            out_lpips.append(float(lpips_fn(rgb, tgt).mean()))
    res_d = {"psnr": float(np.mean(out_psnr)),
             "ssim": float(np.mean(out_ssim))}
    if out_lpips:
        res_d["lpips"] = float(np.mean(out_lpips))
    return res_d
