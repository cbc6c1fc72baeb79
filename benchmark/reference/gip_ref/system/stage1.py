"""Frozen copy of gaussianip_tpu_torch/system/stage1.py, plain PyTorch.

Stage-1 trainer: the training step (port of gaussianip_tpu/system/stage1.py;
the benchmark's window runs the step back to back, with no densify or
prune, in one process, so the schedule loop and the data-parallel paths
are not copied).

One step: sample cameras, draw the pose maps, render, guidance loss +
sparsity/opaque regularizers, backward (autograd; the compositor's backward
is K2), viewspace-gradient densify stats, Adam. The step draws its camera
batch and the guidance's random draws from a torch.Generator and hands
them to the inner step (`make_inner_step`), which a test can call with
injected draws.

Losses: loss_sds * lambda_sds + mean(sqrt(norm_depth^2 + 0.01)) *
lambda_sparsity + bce(norm_depth, norm_depth) * lambda_opaque, with
norm_depth = depth / max(depth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..data.cameras import camera_from_c2w
from ..data.sampler import CameraSamplerConfig, sample_train_batch
from ..human.posemap import openpose_draw
from ..model.adam import AdamHyper, AdamState, adam_step, init_adam
from ..model.densify import DensifyStats, add_stats, init_stats
from ..model.gaussians import PARAM_FIELDS, GaussianState
from ..render.render import RenderConfig, render


@dataclass(frozen=True)
class Stage1Config:
    render_height: int = 512
    render_width: int = 512
    head_offset: float = 0.65
    bg_white: bool = False
    lambda_sds: float = 1.0
    lambda_sparsity: float = 1.0
    lambda_opaque: float = 0.0
    # densify & prune
    densify_prune_start_step: int = 200
    densify_prune_end_step: int = 1700
    densify_prune_interval: int = 500
    densify_prune_min_opacity: float = 0.04
    densify_prune_world_size_threshold: float = 0.015
    prune_only_start_step: int = 1700
    prune_only_end_step: int = 1900
    prune_only_interval: int = 300
    prune_opacity_threshold: float = 0.04
    prune_world_size_threshold: float = 0.015
    max_grad: float = 2e-4
    cameras_extent: float = 4.0
    max_steps: int = 2400
    # exclude gaussians near the hands from the densification stats
    disable_hand_densification: bool = False
    hand_radius: float = 0.05


class TrainState(NamedTuple):
    gaussians: GaussianState
    opt: AdamState
    stats: DensifyStats
    step: int


def init_train_state(gaussians: GaussianState) -> TrainState:
    return TrainState(gaussians, init_adam(gaussians),
                      init_stats(gaussians.capacity, gaussians.device), 0)


def make_inner_step(cfg: Stage1Config, cam_cfg: CameraSamplerConfig,
                    render_cfg: RenderConfig, adam_hyper: AdamHyper,
                    guidance: Callable, skel_points3d, hand_centers=None):
    """`inner(ts, batch, draws) -> (ts, metrics)`: one step on a given
    camera batch and the guidance's draws (whatever its `sample_noise`
    returns, passed through unread; tensors with the batch on axis 0).
    skel_points3d: [18, 3] world keypoints; hand_centers: [2, 3] wrists
    (disable_hand_densification)."""
    h, w = cfg.render_height, cfg.render_width

    def inner(ts: TrainState, batch, draws):
        g = ts.gaussians
        dev = g.device
        b_all = batch.c2w.shape[0]
        bg = torch.full((3,), 1.0 if cfg.bg_white else 0.0, device=dev)
        points3d = torch.as_tensor(np.asarray(skel_points3d, np.float32),
                                   device=dev)
        cams = camera_from_c2w(batch.c2w, batch.fovy, h, w)
        head_zoom = ((batch.center_z == cfg.head_offset)
                     & (batch.azimuth_deg > 0))
        pose_images, all_vis, _ = openpose_draw(
            points3d, batch.mvp_mtx, batch.azimuth_deg, head_zoom, h, w)

        leaves = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        offset = torch.zeros((batch.c2w.shape[0], g.capacity, 2),
                             device=dev, requires_grad=True)
        out = render(g.replace(**leaves), cams, bg, render_cfg,
                     mean2d_offset=offset)
        gout = guidance(ts.step, draws, out.rgb, pose_images, {
            "all_vis": all_vis,
            "elevation": batch.elevation_deg,
            "azimuth": batch.azimuth_deg,
            "center": batch.center_z,
            "camera_distances": batch.camera_distances,
            "batch_size": b_all,
        })
        loss = gout["loss_sds"] * cfg.lambda_sds
        norm_depth = out.depth / (out.depth.max() + 1e-5)
        loss_sparsity = torch.sqrt(norm_depth ** 2 + 0.01).mean()
        loss = loss + loss_sparsity * cfg.lambda_sparsity
        if cfg.lambda_opaque:
            nd = torch.clamp(norm_depth, 1e-3, 1 - 1e-3)
            loss_opaque = -(nd * torch.log(nd)
                            + (1 - nd) * torch.log(1 - nd)).mean()
            loss = loss + loss_opaque * cfg.lambda_opaque
        grads = torch.autograd.grad(
            loss, [leaves[f] for f in PARAM_FIELDS] + [offset])

        with torch.no_grad():
            # the offset's gradient summed over the views (add_stats
            # takes the norm of the sum)
            grads = list(grads[:-1]) + [grads[-1].sum(dim=0)]
            # densification statistics
            radii = out.radii.amax(dim=0)
            visibility = (out.radii > 0).any(dim=0)
            if cfg.disable_hand_densification and hand_centers is not None:
                hc = torch.as_tensor(np.asarray(hand_centers, np.float32),
                                     device=dev)
                dist = torch.linalg.norm(g.xyz[:, None, :] - hc[None],
                                         dim=-1)
                visibility = visibility & ~(dist.amin(dim=-1)
                                            < cfg.hand_radius)
            stats = add_stats(ts.stats, grads[-1], radii, visibility)
            new_g, new_opt = adam_step(
                g, dict(zip(PARAM_FIELDS, grads[:-1])), ts.opt, adam_hyper,
                ts.step)
            metrics = {
                "loss": loss.detach(),
                "loss_sds": gout["loss_sds"].detach(),
                "loss_sparsity": loss_sparsity.detach(),
            }
            for k in ("grad_norm", "t_mean"):  # the guidance's diagnostics
                if k in gout:
                    metrics[k] = gout[k].detach()
            metrics["n_active"] = new_g.n_active
            metrics["n_dropped_instances"] = out.n_dropped.max()
        return TrainState(new_g, new_opt, stats, ts.step + 1), metrics

    return inner


def make_train_step(cfg: Stage1Config, cam_cfg: CameraSamplerConfig,
                    render_cfg: RenderConfig, adam_hyper: AdamHyper,
                    guidance: Callable, skel_points3d, hand_centers=None):
    """`step(ts, generator) -> (ts, metrics)`: draws the camera batch, then
    the guidance's draws, from `generator` (on the state's device) and runs
    the inner step. The guidance offers `sample_noise(generator, shape,
    device)`, with `shape` the render's [B, H, W, 3]; what it returns is
    opaque to the step (one tensor for the stub guidance, a dict for
    AHDSGuidance) and goes back as `guidance(step, draws, rgb, control,
    aux)`, which must be differentiable in rgb; aux["batch_size"] is the
    whole batch's B, over which its loss is a mean."""
    inner = make_inner_step(cfg, cam_cfg, render_cfg, adam_hyper, guidance,
                            skel_points3d, hand_centers)
    shape = (cam_cfg.batch_size, cfg.render_height, cfg.render_width, 3)

    def step(ts: TrainState, generator: torch.Generator):
        dev = ts.gaussians.device
        batch = sample_train_batch(cam_cfg, generator, ts.step, dev)
        draws = guidance.sample_noise(generator, shape, dev)
        return inner(ts, batch, draws)

    return step
