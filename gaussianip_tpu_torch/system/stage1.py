"""Stage-1 trainer: the training step and the host schedule loop (port of
gaussianip_tpu/system/stage1.py).

One step: sample cameras, draw the pose maps, render, guidance loss +
sparsity/opaque regularizers, backward (autograd; the compositor's backward
is K2), viewspace-gradient densify stats, Adam. Densify / prune run at
schedule boundaries. The step draws its camera batch and the guidance's
random draws from a torch.Generator and hands them to the inner step
(`make_inner_step`), which a test can call with injected draws.

Data parallel (`group`, parallel/mesh.py; the JAX package's `mesh=`): every
rank draws the whole batch from the same generator and keeps its own rows,
so the draws, and the densify's, equal a single process's. Each rank's loss
is its share of the global loss: the guidance divides by the global batch,
the regularizer means are scaled by the rank's share of the views, and the
depth normalisation takes the global max (`global_max`). The parameter
gradients and the viewspace-offset gradient summed over the views are
all-reduced before Adam and before `add_stats` takes its norm; the radii
take the max over ranks, the visibility the any. Adam, densify and prune
then run identically on every rank.

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
from ..model.densify import (
    DensifyStats,
    add_stats,
    densify_and_prune,
    init_stats,
    prune_only,
)
from ..model.gaussians import PARAM_FIELDS, GaussianState, state_from_numpy
from ..parallel.mesh import (all_max, all_sum, all_sum_many, global_max,
                             local_rows, world_size)
from ..render.render import RenderConfig, render
from ..utils.profiling import span


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


def train_state_from_numpy(d: dict, device="cuda") -> TrainState:
    """TrainState from numpy arrays: d["gaussians"] as state_from_numpy
    takes it, d["m"] / d["v"] per parameter field, d["adam_count"],
    d["stats"] with xyz_grad_accum / denom / max_radii2d, and d["step"]."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return TrainState(
        gaussians=state_from_numpy(d["gaussians"], device),
        opt=AdamState(m={f: t(d["m"][f]) for f in PARAM_FIELDS},
                      v={f: t(d["v"][f]) for f in PARAM_FIELDS},
                      count=int(d["adam_count"])),
        stats=DensifyStats(**{k: t(v) for k, v in d["stats"].items()}),
        step=int(d["step"]),
    )


def check_divides(batch_size: int, group, what: str = "camera batch"):
    """Raise unless the batch divides over the group's ranks."""
    if batch_size % world_size(group):
        raise ValueError(f"{what} {batch_size} must divide over the "
                         f"{world_size(group)} data-parallel ranks")


def _global_metrics(group, metrics: dict, share: float) -> dict:
    """The batch's metrics from the ranks' shares: the losses summed,
    grad_norm the root of the summed squares, t_mean the batch mean."""
    part = {k: v ** 2 if k == "grad_norm" else v * share if k == "t_mean"
            else v for k, v in metrics.items()}
    out = dict(zip(part, all_sum(group, torch.stack(
        [v.float() for v in part.values()]))))
    if "grad_norm" in out:
        out["grad_norm"] = out["grad_norm"].sqrt()
    return out


def make_inner_step(cfg: Stage1Config, cam_cfg: CameraSamplerConfig,
                    render_cfg: RenderConfig, adam_hyper: AdamHyper,
                    guidance: Callable, skel_points3d, hand_centers=None,
                    group=None):
    """`inner(ts, batch, draws) -> (ts, metrics)`: one step on a given
    camera batch and the guidance's draws (whatever its `sample_noise`
    returns, passed through unread; tensors with the batch on axis 0).
    skel_points3d: [18, 3] world keypoints; hand_centers: [2, 3] wrists
    (disable_hand_densification). With a data-parallel `group` the batch
    and draws are the whole batch's, and the rank keeps its rows."""
    h, w = cfg.render_height, cfg.render_width

    def inner(ts: TrainState, batch, draws):
        g = ts.gaussians
        dev = g.device
        b_all = batch.c2w.shape[0]
        batch, draws = local_rows(group, (batch, draws))
        share = batch.c2w.shape[0] / b_all  # 1.0 in a single process
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
        with span("render"):
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
        norm_depth = out.depth / (global_max(group, out.depth) + 1e-5)
        loss_sparsity = torch.sqrt(norm_depth ** 2 + 0.01).mean() * share
        loss = loss + loss_sparsity * cfg.lambda_sparsity
        if cfg.lambda_opaque:
            nd = torch.clamp(norm_depth, 1e-3, 1 - 1e-3)
            loss_opaque = -(nd * torch.log(nd)
                            + (1 - nd) * torch.log(1 - nd)).mean() * share
            loss = loss + loss_opaque * cfg.lambda_opaque
        with span("backward", split=(out.rgb, "vae_encode.backward",
                                     "render.backward")):
            grads = torch.autograd.grad(
                loss, [leaves[f] for f in PARAM_FIELDS] + [offset])

        with torch.no_grad(), span("adam"):
            # the views' gradients: summed over the ranks, the offset's
            # over the views first (add_stats takes the norm of the sum)
            grads = all_sum_many(group, list(grads[:-1])
                                 + [grads[-1].sum(dim=0)])
            # densification statistics
            radii = out.radii.amax(dim=0)
            visibility = (out.radii > 0).any(dim=0)
            if group is not None:
                rv = all_max(group, torch.stack([radii, visibility.to(
                    radii.dtype)]))
                radii, visibility = rv[0], rv[1] > 0
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
            if group is not None:
                metrics = _global_metrics(group, metrics, share)
            metrics["n_active"] = new_g.n_active
            metrics["n_dropped_instances"] = all_max(group,
                                                     out.n_dropped.max())
        return TrainState(new_g, new_opt, stats, ts.step + 1), metrics

    return inner


def make_train_step(cfg: Stage1Config, cam_cfg: CameraSamplerConfig,
                    render_cfg: RenderConfig, adam_hyper: AdamHyper,
                    guidance: Callable, skel_points3d, hand_centers=None,
                    group=None):
    """`step(ts, generator) -> (ts, metrics)`: draws the camera batch, then
    the guidance's draws, from `generator` (on the state's device) and runs
    the inner step. The guidance offers `sample_noise(generator, shape,
    device)`, with `shape` the render's [B, H, W, 3]; what it returns is
    opaque to the step (one tensor for the stub guidance, a dict for
    AHDSGuidance) and goes back as `guidance(step, draws, rgb, control,
    aux)`, which must be differentiable in rgb; aux["batch_size"] is the
    whole batch's B, over which its loss is a mean. With a data-parallel
    `group` every rank draws the whole batch (B = cam_cfg.batch_size,
    which must divide over the ranks) from a generator seeded alike."""
    check_divides(cam_cfg.batch_size, group)
    inner = make_inner_step(cfg, cam_cfg, render_cfg, adam_hyper, guidance,
                            skel_points3d, hand_centers, group)
    shape = (cam_cfg.batch_size, cfg.render_height, cfg.render_width, 3)

    def step(ts: TrainState, generator: torch.Generator):
        dev = ts.gaussians.device
        with span("stage1.step", step=ts.step, device=dev):
            batch = sample_train_batch(cam_cfg, generator, ts.step, dev)
            draws = guidance.sample_noise(generator, shape, dev)
            return inner(ts, batch, draws)

    return step


def make_densify_fns(cfg: Stage1Config):
    """densify(ts, generator) -> (ts, n_dropped); prune(ts) -> ts."""

    def densify(ts: TrainState, generator: torch.Generator):
        g = ts.gaussians
        noise = torch.randn((2, g.capacity, 3), generator=generator,
                            device=g.device)
        g, opt, stats, dropped = densify_and_prune(
            g, ts.opt, ts.stats, noise,
            max_grad=cfg.max_grad,
            min_opacity=cfg.densify_prune_min_opacity,
            extent=cfg.cameras_extent,
            max_world_size=cfg.densify_prune_world_size_threshold)
        return TrainState(g, opt, stats, ts.step), dropped

    def prune(ts: TrainState):
        g, opt, stats = prune_only(ts.gaussians, ts.opt, ts.stats,
                                   cfg.prune_opacity_threshold,
                                   cfg.prune_world_size_threshold)
        return TrainState(g, opt, stats, ts.step)

    return densify, prune


def densify_due(cfg: Stage1Config, step: int) -> bool:
    return (cfg.densify_prune_start_step < step < cfg.densify_prune_end_step
            and step % cfg.densify_prune_interval == 0)


def prune_due(cfg: Stage1Config, step: int) -> bool:
    return (cfg.prune_only_start_step < step < cfg.prune_only_end_step
            and step % cfg.prune_only_interval == 0)


def train_stage1(ts: TrainState, cfg: Stage1Config,
                 cam_cfg: CameraSamplerConfig, render_cfg: RenderConfig,
                 adam_hyper: AdamHyper, guidance: Callable, skel_points3d,
                 generator: torch.Generator, n_steps: int | None = None,
                 log_every: int = 100,
                 log_fn: Callable[[int, dict], None] | None = None,
                 hand_centers=None, val_every: int = 0,
                 val_fn: Callable[[int, TrainState], None] | None = None,
                 ckpt_every: int = 0,
                 ckpt_fn: Callable[[int, TrainState], None] | None = None,
                 group=None):
    """Host schedule loop for stage 1. `generator` lives on the state's
    device; metrics reach `log_fn` as host floats. After step index i,
    `val_fn(i, ts)` runs when i % val_every == 0 and i > 0, and
    `ckpt_fn(i, ts)` when i > the start step and i % ckpt_every == 0.

    A resumed run (ts.step > 0) reseeds `generator` from its initial seed
    and the start step (resume_seed), so that it does not replay the draws
    of the run it continues.

    group: a data-parallel group (parallel/mesh.py); the camera batch
    splits over its ranks, each of which runs this loop with the same `ts`
    and a generator seeded alike, and calls every callback (the caller
    decides which rank writes)."""
    step_fn = make_train_step(cfg, cam_cfg, render_cfg, adam_hyper, guidance,
                              skel_points3d, hand_centers, group)
    densify, prune = make_densify_fns(cfg)
    n_steps = cfg.max_steps if n_steps is None else n_steps
    start = ts.step
    if start > 0:
        generator.manual_seed(resume_seed(generator.initial_seed(), start))
    for i in range(start, start + n_steps):
        ts, metrics = step_fn(ts, generator)
        if densify_due(cfg, i):
            ts, _ = densify(ts, generator)
        elif prune_due(cfg, i):
            ts = prune(ts)
        if log_fn is not None and i % log_every == 0:
            log_fn(i, {k: float(v) for k, v in metrics.items()})
        if val_fn is not None and val_every and i % val_every == 0 and i > 0:
            val_fn(i, ts)
        if ckpt_fn is not None and ckpt_every and i > start \
                and i % ckpt_every == 0:
            ckpt_fn(i, ts)
    return ts


def resume_seed(seed: int, start: int) -> int:
    """The generator seed of a run resumed at step `start` > 0 from a run
    seeded `seed`: a 63-bit mix of both, distinct for each start step."""
    return (seed * 0x9E3779B97F4A7C15 + start) % (1 << 63)
