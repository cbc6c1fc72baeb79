"""Frozen copy of gaussianip_tpu_torch/data/sampler.py, plain PyTorch.

Camera sampling: random training cameras and the refine orbit (port of
gaussianip_tpu/data/sampler.py).

The random draws are split from the geometry: `sample_train_batch` draws
`CameraDraws` (uniforms in [0, 1)) from a `torch.Generator`, and
`train_batch_from_draws` turns them into cameras, so a test can hand the
JAX sampler's uniforms to the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.camera_math import (
    deg2rad,
    get_mvp_matrix,
    gl_projection_matrix,
    look_at_c2w,
    spherical_to_position,
)


@dataclass(frozen=True)
class CameraSamplerConfig:
    height: int = 1024
    width: int = 1024
    batch_size: int = 4
    elevation_range: tuple = (-30.0, 30.0)
    azimuth_range: tuple = (-180.0, 180.0)
    camera_distance_range: tuple = (1.3, 1.7)
    fovy_range: tuple = (40.0, 70.0)
    batch_uniform_azimuth: bool = True
    # head / back zoom-in modes
    enable_near_head_poses: bool = True
    enable_near_back_poses: bool = True
    head_offset: float = 0.65
    back_offset: float = 0.65
    head_camera_distance_range: tuple = (0.4, 0.6)
    back_camera_distance_range: tuple = (0.6, 0.8)
    head_prob: float = 0.25
    back_prob: float = 0.2
    head_start_step: int = 1200
    head_end_step: int = 3600
    back_start_step: int = 1200
    back_end_step: int = 3600
    head_azimuth_range: tuple = (0.0, 180.0)
    back_azimuth_range: tuple = (-180.0, 0.0)
    # eval
    eval_height: int = 1024
    eval_width: int = 1024
    eval_elevation_deg: float = 5.0
    eval_camera_distance: float = 1.8
    eval_camera_distance_head: float = 0.6
    eval_fovy_deg: float = 70.0
    n_val_views: int = 8
    n_test_views: int = 144


class CameraBatch(NamedTuple):
    mvp_mtx: torch.Tensor  # [B, 4, 4] (threestudio convention, pose maps)
    c2w: torch.Tensor  # [B, 4, 4]
    center_z: torch.Tensor  # [B] 0.0 body / head_offset zoomed
    elevation_deg: torch.Tensor  # [B]
    azimuth_deg: torch.Tensor  # [B]
    camera_distances: torch.Tensor  # [B]
    fovy: torch.Tensor  # [B] radians


class CameraDraws(NamedTuple):
    """Uniform [0, 1) draws behind one training batch."""
    r1: torch.Tensor  # [] head-zoom coin
    r2: torch.Tensor  # [] back-zoom coin
    u_el: torch.Tensor  # [B]
    u_az: torch.Tensor  # [B]
    u_d: torch.Tensor  # [B]
    u_f: torch.Tensor  # [B]


def draw_camera_uniforms(cfg: CameraSamplerConfig, generator: torch.Generator,
                         device="cuda") -> CameraDraws:
    b = cfg.batch_size
    u = torch.rand(2 + 4 * b, generator=generator, device=device)
    return CameraDraws(u[0], u[1], *u[2:].view(4, b).unbind(0))


def train_batch_from_draws(cfg: CameraSamplerConfig, d: CameraDraws,
                           step: int) -> CameraBatch:
    """One training camera batch; `step` gates the zoom-in windows."""
    b = cfg.batch_size
    dev = d.u_el.device
    in_head_win = cfg.head_start_step <= step <= cfg.head_end_step
    in_back_win = cfg.back_start_step <= step <= cfg.back_end_step
    zoom_head = (d.r1 < cfg.head_prob) & (cfg.enable_near_head_poses
                                          and in_head_win)
    zoom_back = (~zoom_head & (d.r2 < cfg.back_prob)
                 & (cfg.enable_near_back_poses and in_back_win))

    def pick(head_v, back_v, norm_v):
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return torch.where(zoom_head, t(head_v),
                           torch.where(zoom_back, t(back_v), t(norm_v)))

    az_lo = pick(cfg.head_azimuth_range[0], cfg.back_azimuth_range[0],
                 cfg.azimuth_range[0])
    az_hi = pick(cfg.head_azimuth_range[1], cfg.back_azimuth_range[1],
                 cfg.azimuth_range[1])
    d_lo = pick(cfg.head_camera_distance_range[0],
                cfg.back_camera_distance_range[0],
                cfg.camera_distance_range[0])
    d_hi = pick(cfg.head_camera_distance_range[1],
                cfg.back_camera_distance_range[1],
                cfg.camera_distance_range[1])

    el_lo, el_hi = cfg.elevation_range
    elevation_deg = d.u_el * (el_hi - el_lo) + el_lo
    if cfg.batch_uniform_azimuth:
        ar = torch.arange(b, dtype=torch.float32, device=dev)
        azimuth_deg = (d.u_az + ar) / b * (az_hi - az_lo) + az_lo
    else:
        azimuth_deg = d.u_az * (az_hi - az_lo) + az_lo
    distances = d.u_d * (d_hi - d_lo) + d_lo
    f_lo, f_hi = cfg.fovy_range
    fovy_deg = d.u_f * (f_hi - f_lo) + f_lo

    positions = spherical_to_position(
        deg2rad(elevation_deg), deg2rad(azimuth_deg), distances)
    offset = pick(cfg.head_offset, cfg.back_offset, 0.0)
    center = torch.zeros((b, 3), device=dev)
    center[:, 2] += offset
    positions = positions.clone()
    positions[:, 2] += offset

    up = torch.tensor([[0.0, 0, 1]], device=dev).expand(b, 3)
    c2w = look_at_c2w(positions, center, up)
    fovy = deg2rad(fovy_deg)
    proj = gl_projection_matrix(fovy, cfg.width / cfg.height, 0.1, 1000.0)
    return CameraBatch(
        mvp_mtx=get_mvp_matrix(c2w, proj),
        c2w=c2w,
        center_z=center[:, 2],
        elevation_deg=elevation_deg,
        azimuth_deg=azimuth_deg,
        camera_distances=distances,
        fovy=fovy,
    )


def sample_train_batch(cfg: CameraSamplerConfig, generator: torch.Generator,
                       step: int, device="cuda") -> CameraBatch:
    """One random training camera batch drawn from `generator`."""
    return train_batch_from_draws(
        cfg, draw_camera_uniforms(cfg, generator, device), step)


def refine_orbit_batch(n_views: int, elevation_deg: float, distance: float,
                       fovy_deg: float, height: int, width: int,
                       device="cuda") -> CameraBatch:
    """The stage-2 refinement orbit: n_views azimuths evenly over
    [-180, 180) at one elevation, distance and fovy, looking at the
    origin."""
    azimuth_deg = torch.linspace(-180.0, 180.0, n_views + 1,
                                 device=device)[:n_views]
    elev = torch.full((n_views,), float(elevation_deg), device=device)
    d = torch.full((n_views,), float(distance), device=device)
    fovy = deg2rad(torch.full((n_views,), float(fovy_deg), device=device))
    pos = spherical_to_position(deg2rad(elev), deg2rad(azimuth_deg), d)
    up = torch.tensor([[0.0, 0, 1]], device=device).expand(n_views, 3)
    c2w = look_at_c2w(pos, torch.zeros((n_views, 3), device=device), up)
    proj = gl_projection_matrix(fovy, width / height, 0.1, 1000.0)
    return CameraBatch(
        mvp_mtx=get_mvp_matrix(c2w, proj),
        c2w=c2w,
        center_z=torch.zeros((n_views,), device=device),
        elevation_deg=elev,
        azimuth_deg=azimuth_deg,
        camera_distances=d,
        fovy=fovy,
    )
