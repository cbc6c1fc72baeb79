"""Frozen copy of gaussianip_tpu_torch/system/stage3.py, plain PyTorch.

Stage-3 reconstruction: fit the avatar to the VCR-refined views (port of
gaussianip_tpu/system/stage3.py).

Each step renders `train_bs` of the 32 refine-orbit views at 1024^2 (the
view ids are an argument: `draw_view_ids` draws them), crops
[60:890, 220:800], halves it with the antialiased linear resize and
minimizes 10 * L1 + 15 * LPIPS against the refined targets. Adam's LR
schedule runs from the global step refine_start_step + step; the densify
statistics come from the viewspace offset's gradient summed over the views.
One densify_and_prune (min_opacity 0.05) fires after the step of index
densify_at_global_step - refine_start_step (global 2500). The reference's
stage-3 prune_only never fires, so it is left out, as in the JAX package.
Only the step and the densify are copied: the benchmark drives them in
train_stage3's schedule, in one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..data.cameras import camera_from_c2w
from ..data.sampler import CameraBatch
from ..model.adam import AdamHyper, adam_step
from ..model.densify import add_stats, densify_and_prune
from ..model.gaussians import PARAM_FIELDS
from ..ops.resize import linear_resize
from ..render.render import RenderConfig, render
from .refine import CROP_X, CROP_Y
from .stage1 import TrainState


@dataclass(frozen=True)
class Stage3Config:
    height: int = 1024
    width: int = 1024
    refine_start_step: int = 2400
    max_steps: int = 800
    train_bs: int = 4
    lambda_l1: float = 10.0
    lambda_lpips: float = 15.0
    densify_at_global_step: int = 2500
    max_grad: float = 2e-4
    densify_min_opacity: float = 0.05
    densify_world_size_threshold: float = 0.015
    cameras_extent: float = 4.0
    bg_white: bool = False
    # the crop window in pixels at (height, width)
    crop_y: tuple = CROP_Y
    crop_x: tuple = CROP_X

    @property
    def densify_step(self) -> int:
        """The step index after which the one densify fires."""
        return self.densify_at_global_step - self.refine_start_step


def draw_view_ids(generator: torch.Generator, n_views: int, train_bs: int,
                  n_steps: int, device="cuda") -> torch.Tensor:
    """[n_steps, train_bs] view ids, distinct within each step."""
    return torch.stack([torch.randperm(n_views, generator=generator,
                                       device=device)[:train_bs]
                        for _ in range(n_steps)])


def make_stage3_step(cfg: Stage3Config, render_cfg: RenderConfig,
                     adam_hyper: AdamHyper, orbit: CameraBatch,
                     refined_targets, lpips_fn: Callable | None = None):
    """`step(ts, ids) -> (ts, metrics)`: one step on the views `ids`
    [train_bs] of `orbit` against refined_targets [32, Ht, Wt, 3]
    (cropped and halved). lpips_fn: (x, y) -> [B] distances, or None for
    L1 alone."""
    h, w = cfg.height, cfg.width
    cy, cx = cfg.crop_y, cfg.crop_x
    th, tw = refined_targets.shape[1], refined_targets.shape[2]

    def step(ts: TrainState, ids):
        g = ts.gaussians
        dev = g.device
        bg = torch.full((3,), 1.0 if cfg.bg_white else 0.0, device=dev)
        cams = camera_from_c2w(orbit.c2w[ids], orbit.fovy[ids], h, w)
        tgt = refined_targets[ids]
        leaves = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        offset = torch.zeros((ids.shape[0], g.capacity, 2), device=dev,
                             requires_grad=True)
        out = render(g.replace(**leaves), cams, bg, render_cfg,
                     mean2d_offset=offset)
        crop = out.rgb[:, cy[0]:cy[1], cx[0]:cx[1], :]
        small = linear_resize(crop.permute(0, 3, 1, 2), th,
                              tw).permute(0, 2, 3, 1)
        l1 = (small - tgt).abs().mean()
        loss = cfg.lambda_l1 * l1
        lp = torch.zeros((), device=dev)
        if lpips_fn is not None:
            lp = lpips_fn(small, tgt).mean()
            loss = loss + cfg.lambda_lpips * lp
        grads = torch.autograd.grad(
            loss, [leaves[f] for f in PARAM_FIELDS] + [offset])
        with torch.no_grad():
            grads = list(grads[:-1]) + [grads[-1].sum(dim=0)]
            stats = add_stats(ts.stats, grads[-1], out.radii.amax(dim=0),
                              (out.radii > 0).any(dim=0))
            new_g, new_opt = adam_step(
                g, dict(zip(PARAM_FIELDS, grads[:-1])), ts.opt, adam_hyper,
                ts.step + cfg.refine_start_step)
            loss, l1, lp = torch.stack([loss, l1, lp]).detach()
        metrics = {"loss": loss, "l1": l1, "lpips": lp,
                   "n_active": new_g.n_active}
        return TrainState(new_g, new_opt, stats, ts.step + 1), metrics

    return step


def densify(ts: TrainState, cfg: Stage3Config, split_noise):
    """The stage's one densify_and_prune; split_noise [2, CAP, 3]. ->
    (ts, instances dropped)."""
    g, opt, stats, dropped = densify_and_prune(
        ts.gaussians, ts.opt, ts.stats, split_noise, max_grad=cfg.max_grad,
        min_opacity=cfg.densify_min_opacity, extent=cfg.cameras_extent,
        max_world_size=cfg.densify_world_size_threshold)
    return TrainState(g, opt, stats, ts.step), dropped
