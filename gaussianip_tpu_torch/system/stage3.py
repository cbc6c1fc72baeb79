"""Stage-3 reconstruction: fit the avatar to the VCR-refined views (port of
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
The turntable renders the eval orbit after training.

Data parallel (`group`, parallel/mesh.py): every rank takes its columns
of the step's view ids; L1 and LPIPS are means over the whole batch (each
rank's loss is its share), and the gradients, statistics and the densify
follow stage 1's rules (system/stage1.py).
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
from ..parallel.mesh import (all_max, all_sum, all_sum_many, local_rows,
                             world_size)
from ..render.render import RenderConfig, render
from .refine import CROP_X, CROP_Y, RENDER_BATCH
from .stage1 import TrainState, check_divides


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
                     refined_targets, lpips_fn: Callable | None = None,
                     group=None):
    """`step(ts, ids) -> (ts, metrics)`: one step on the views `ids`
    [train_bs] of `orbit` against refined_targets [32, Ht, Wt, 3]
    (cropped and halved). lpips_fn: (x, y) -> [B] distances, or None for
    L1 alone. With a data-parallel `group`, `ids` are the whole step's and
    the rank renders its columns."""
    h, w = cfg.height, cfg.width
    cy, cx = cfg.crop_y, cfg.crop_x
    th, tw = refined_targets.shape[1], refined_targets.shape[2]
    check_divides(cfg.train_bs, group, "stage-3 view batch")

    def step(ts: TrainState, ids):
        share = 1.0 / world_size(group)  # the rank's share of the views
        ids = local_rows(group, ids)
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
        l1 = (small - tgt).abs().mean() * share
        loss = cfg.lambda_l1 * l1
        lp = torch.zeros((), device=dev)
        if lpips_fn is not None:
            lp = lpips_fn(small, tgt).mean() * share
            loss = loss + cfg.lambda_lpips * lp
        grads = torch.autograd.grad(
            loss, [leaves[f] for f in PARAM_FIELDS] + [offset])
        with torch.no_grad():
            grads = all_sum_many(group, list(grads[:-1])
                                 + [grads[-1].sum(dim=0)])
            radii = all_max(group, out.radii.amax(dim=0))
            stats = add_stats(ts.stats, grads[-1], radii,
                              all_max(group, (out.radii > 0).any(dim=0)))
            new_g, new_opt = adam_step(
                g, dict(zip(PARAM_FIELDS, grads[:-1])), ts.opt, adam_hyper,
                ts.step + cfg.refine_start_step)
            m = torch.stack([loss, l1, lp]).detach()
            loss, l1, lp = all_sum(group, m)
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


def train_stage3(ts: TrainState, cfg: Stage3Config, render_cfg: RenderConfig,
                 adam_hyper: AdamHyper, orbit: CameraBatch, refined_targets,
                 view_ids, split_noise, lpips_fn: Callable | None = None,
                 log_every: int = 100,
                 log_fn: Callable[[int, dict], None] | None = None,
                 group=None):
    """Runs len(view_ids) steps from ts.step; view_ids [n_steps, train_bs]
    (`draw_view_ids`), split_noise [2, CAP, 3] for the densify. Metrics
    reach `log_fn` as host floats. With a data-parallel `group` every rank
    passes the same view_ids and split_noise; the step's views split over
    the ranks."""
    step_fn = make_stage3_step(cfg, render_cfg, adam_hyper, orbit,
                               refined_targets, lpips_fn, group)
    start = ts.step
    for i in range(start, start + view_ids.shape[0]):
        ts, metrics = step_fn(ts, view_ids[i - start])
        if log_fn is not None and i % log_every == 0:
            log_fn(i, {k: float(v) for k, v in metrics.items()})
        if i == cfg.densify_step:
            ts, _ = densify(ts, cfg, split_noise)
    return ts


@torch.no_grad()
def render_turntable(gaussians, orbit: CameraBatch, height: int, width: int,
                     render_cfg: RenderConfig = RenderConfig()):
    """The final avatar's frames [N, H, W, 3] on a black background, in
    sweeps of RENDER_BATCH views (the test orbit:
    data/sampler.py:eval_orbit_batch with split "test")."""
    bg = torch.zeros(3, device=gaussians.device)
    b = RENDER_BATCH
    return torch.cat([
        render(gaussians, camera_from_c2w(orbit.c2w[i:i + b],
                                          orbit.fovy[i:i + b], height,
                                          width), bg, render_cfg).rgb
        for i in range(0, orbit.c2w.shape[0], b)])
