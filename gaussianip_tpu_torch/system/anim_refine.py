"""Animation-space AHDS refinement, "stage 4" (port of
gaussianip_tpu/system/anim_refine.py): per step, sample a motion pose,
deform the canonical gaussians to it by LBS-weight diffusion
(human/lbs_deform.py), render the deformed avatar and apply the guidance,
so that the avatar stays plausible under articulation. Gradients flow
through the deformation, the nearest-vertex weights included, to the
canonical parameters of all six fields.

Every capacity row is deformed, padding included, as in the JAX package:
a padded row (xyz = 1e8) is far from every template vertex, so its
blended transform is 0; it lands at the origin with the rotation factor
rotmat_to_quat(0) = (0, 0, 0, 1), and its opacity-tightened radius culls
it in the render.

`make_anim_refine_inner` runs one step on an injected camera batch, pose
index and guidance draws; `make_anim_refine_step` draws them from a
torch.Generator (camera batch, then pose index, then the guidance's
draws), as system/stage1.py splits its step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..data.cameras import camera_from_c2w
from ..data.sampler import CameraSamplerConfig, sample_train_batch
from ..human.lbs_deform import (a2pose_transforms, deform_points,
                                lbs_diffuse_transforms)
from ..human.smplx import SMPLXParams
from ..model.adam import AdamHyper, adam_step
from ..model.gaussians import PARAM_FIELDS
from ..render.render import RenderConfig, render
from .stage1 import TrainState


@dataclass(frozen=True)
class AnimRefineConfig:
    render_height: int = 512
    render_width: int = 512
    lambda_sds: float = 1.0
    lbs_k: int = 6
    max_steps: int = 800


def make_anim_refine_inner(cfg: AnimRefineConfig,
                           cam_cfg: CameraSamplerConfig,
                           render_cfg: RenderConfig, adam_hyper: AdamHyper,
                           guidance: Callable, smplx_params: SMPLXParams,
                           motion_poses, canonical: dict):
    """`inner(ts, batch, pose_index, draws) -> (ts, {"loss"})`, with
    pose_index an int or a 0-d integer tensor. motion_poses: [T, 21, 3]
    axis-angle body poses; canonical: a_verts [V, 3], inv_T_t2a
    [V, 4, 4] and canonical_offsets [V, 3] of the A-pose forward
    (LBSDeformer's fields)."""
    h, w = cfg.render_height, cfg.render_width
    dev = canonical["a_verts"].device
    motion = torch.as_tensor(motion_poses, dtype=torch.float32, device=dev)

    def inner(ts: TrainState, batch, pose_index, draws):
        g = ts.gaussians
        with torch.no_grad():
            T_a2pose = a2pose_transforms(
                smplx_params, canonical["inv_T_t2a"],
                canonical["canonical_offsets"], body_pose=motion[pose_index])
        cams = camera_from_c2w(batch.c2w, batch.fovy, h, w)
        leaves = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        T = lbs_diffuse_transforms(smplx_params.lbs_weights, T_a2pose,
                                   leaves["xyz"], canonical["a_verts"],
                                   K=cfg.lbs_k)
        xyz, rot = deform_points(T, leaves["xyz"], leaves["rotation"])
        posed = g.replace(**{**leaves, "xyz": xyz, "rotation": rot})
        out = render(posed, cams, torch.zeros(3, device=g.device),
                     render_cfg)
        rgb = out.rgb
        gout = guidance(ts.step, draws, rgb, torch.zeros_like(rgb), {
            "all_vis": torch.zeros((rgb.shape[0],), device=g.device),
            "elevation": batch.elevation_deg,
            "azimuth": batch.azimuth_deg,
            "center": batch.center_z,
            "camera_distances": batch.camera_distances,
        })
        loss = gout["loss_sds"] * cfg.lambda_sds
        grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS])
        new_g, new_opt = adam_step(g, dict(zip(PARAM_FIELDS, grads)),
                                   ts.opt, adam_hyper, ts.step)
        return (TrainState(new_g, new_opt, ts.stats, ts.step + 1),
                {"loss": loss.detach()})

    return inner


def make_anim_refine_step(cfg: AnimRefineConfig,
                          cam_cfg: CameraSamplerConfig,
                          render_cfg: RenderConfig, adam_hyper: AdamHyper,
                          guidance: Callable, smplx_params: SMPLXParams,
                          motion_poses, canonical: dict):
    """`step(ts, generator) -> (ts, {"loss"})`: draws the camera batch, the
    pose index and the guidance's draws from `generator` (on the state's
    device), then runs the inner step."""
    inner = make_anim_refine_inner(cfg, cam_cfg, render_cfg, adam_hyper,
                                   guidance, smplx_params, motion_poses,
                                   canonical)
    n_poses = len(motion_poses)
    shape = (cam_cfg.batch_size, cfg.render_height, cfg.render_width, 3)

    def step(ts: TrainState, generator: torch.Generator):
        dev = ts.gaussians.device
        batch = sample_train_batch(cam_cfg, generator, ts.step, dev)
        pose_index = torch.randint(0, n_poses, (), generator=generator,
                                   device=dev)
        draws = guidance.sample_noise(generator, shape, dev)
        return inner(ts, batch, pose_index, draws)

    return step
