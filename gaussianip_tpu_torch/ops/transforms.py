"""Rotation, covariance and activation math for 3D Gaussian splats (port
of gaussianip_tpu/ops/transforms.py)."""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion(s) [..., 4] (w, x, y, z) -> rotation [..., 3, 3]
    (normalized internally, the rotation activation is L2-normalize)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


def build_scaling_rotation(scales: torch.Tensor,
                           quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3]."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance Sigma = L L^T from activated scales + raw quats."""
    L = build_scaling_rotation(scaling_modifier * scales, quats)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> packed [..., 6] upper triangle, row-major
    (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], -1)


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Exponential log-lerp LR schedule (host float; the step is a host int)."""
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(
        math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
