"""Frozen copy of gaussianip_tpu_torch/ops/camera_math.py, plain PyTorch.

Camera matrix math, batched over a leading camera dim (port of
gaussianip_tpu/ops/camera_math.py).

Two projection conventions coexist, as in the JAX package:
  * the splat-rasterizer convention: matrices stored TRANSPOSED and applied
    to row vectors (p_row @ M);
  * the threestudio convention used for the pose-map MVP: OpenGL-ish with
    flipped y.
"""

from __future__ import annotations

import math

import torch


def fov2focal(fov, pixels):
    return pixels / (2 * torch.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * torch.atan(pixels / (2 * focal))


def splat_projection_matrix(znear: float, zfar: float, fovx, fovy):
    """[B, 4, 4] perspective projection, splat convention (NOT transposed)."""
    tan_y = torch.tan(fovy / 2)
    tan_x = torch.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = torch.zeros(fovy.shape + (4, 4), dtype=torch.float32,
                    device=fovy.device)
    P[..., 0, 0] = znear / right
    P[..., 1, 1] = znear / top
    P[..., 3, 2] = 1.0
    P[..., 2, 2] = zfar / (zfar - znear)
    P[..., 2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def rectified_w2c(c2w):
    """w2c with the sign rectification of the splat camera: invert c2w, then
    negate rows 1:3 of the rotation block and the whole translation column."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    w2c = torch.zeros_like(c2w)
    w2c[..., :3, :3] = Rt
    w2c[..., :3, 3:] = -Rt @ t
    w2c[..., 3, 3] = 1.0
    w2c[..., 1:3, :3] *= -1.0
    w2c[..., :3, 3] *= -1.0
    return w2c


def camera_matrices(c2w, fovy, height: int, width: int, znear=0.01,
                    zfar=100.0):
    """(world_view^T, full_proj^T, camera_center, fovx) for [B] cameras.
    FoVx derives from FoVy through the focal of the height."""
    fovx = focal2fov(fov2focal(fovy, height), width)
    world_view_t = rectified_w2c(c2w).transpose(-1, -2)
    proj = splat_projection_matrix(znear, zfar, fovx, fovy)
    full_proj_t = world_view_t @ proj.transpose(-1, -2)
    # inv_ex: no error check, so no host sync on the card
    cam_center = torch.linalg.inv_ex(world_view_t).inverse[..., 3, :3]
    return world_view_t, full_proj_t, cam_center, fovx


def gl_projection_matrix(fovy, aspect_wh: float, near: float, far: float):
    """threestudio projection for the MVP / pose-map joints, [B, 4, 4]."""
    z = torch.zeros_like(fovy)
    one = torch.ones_like(fovy)
    t = torch.tan(fovy / 2.0)
    rows = [
        torch.stack([1.0 / (t * aspect_wh), z, z, z], -1),
        torch.stack([z, -1.0 / t, z, z], -1),
        torch.stack([z, z, -(far + near) / (far - near) * one,
                     -2.0 * far * near / (far - near) * one], -1),
        torch.stack([z, z, -one, z], -1),
    ]
    return torch.stack(rows, -2)


def get_mvp_matrix(c2w, proj_mtx):
    """MVP = proj @ w2c, batched."""
    R = c2w[:, :3, :3]
    t = c2w[:, :3, 3:]
    w2c = torch.zeros_like(c2w)
    w2c[:, :3, :3] = R.transpose(-1, -2)
    w2c[:, :3, 3:] = -R.transpose(-1, -2) @ t
    w2c[:, 3, 3] = 1.0
    return proj_mtx @ w2c


def look_at_c2w(camera_positions, centers, up):
    """Batched c2w from eye/center/up, column layout [right, up, -lookat | eye]."""

    def norm(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)

    lookat = norm(centers - camera_positions)
    right = norm(torch.linalg.cross(lookat, up))
    up2 = norm(torch.linalg.cross(right, lookat))
    rot = torch.stack([right, up2, -lookat], dim=-1)
    c2w = torch.cat([rot, camera_positions[..., :, None]], dim=-1)
    bottom = torch.zeros_like(c2w[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([c2w, bottom], dim=-2)


def spherical_to_position(elevation, azimuth, distance):
    """(elev, azim, r) -> xyz, +z up, azimuth from +x toward +y."""
    return torch.stack(
        [
            distance * torch.cos(elevation) * torch.cos(azimuth),
            distance * torch.cos(elevation) * torch.sin(azimuth),
            distance * torch.sin(elevation),
        ],
        -1,
    )


def deg2rad(x):
    return x * (math.pi / 180.0)
