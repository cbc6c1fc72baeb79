"""Rotation representation conversions (quaternion / matrix / axis-angle /
euler / 6D), batched and differentiable (port of
gaussianip_tpu/ops/rotations.py). Quaternions are (w, x, y, z), as the
splat attributes."""

from __future__ import annotations

import torch

from .transforms import quat_to_rotmat  # noqa: F401 (re-export)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z): all four Shepperd candidates,
    selected branch-free. The clamp inside the square roots keeps the
    unselected candidates finite, so that their zero share of the gradient
    stays 0 (not 0 x inf = NaN) through `torch.where`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1 + tr) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = safe_sqrt(1 + m00 - m11 - m22) / 2
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = safe_sqrt(1 - m00 + m11 - m22) / 2
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = safe_sqrt(1 - m00 - m11 + m22) / 2
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)

    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = angle / 2
    small = angle < 1e-8
    k = torch.where(small, 0.5,
                    torch.sin(half) / torch.where(small, 1.0, angle))
    return torch.cat([torch.cos(half), aa * k], -1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2 * torch.atan2(sin_half[..., 0], q[..., 0])[..., None]
    small = sin_half < 1e-8
    axis = q[..., 1:] / torch.where(small, 1.0, sin_half)
    return torch.where(small, q[..., 1:] * 2, axis * angle)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    from ..human.smplx import rodrigues

    return rodrigues(aa)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(rotmat_to_quat(R))


def euler_to_matrix(angles: torch.Tensor,
                    convention: str = "XYZ") -> torch.Tensor:
    """Intrinsic euler angles [..., 3] -> rotation matrices."""
    def rot_axis(axis, a):
        c, s = torch.cos(a), torch.sin(a)
        o, z = torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            rows = [[o, z, z], [z, c, -s], [z, s, c]]
        elif axis == "Y":
            rows = [[c, z, s], [z, o, z], [-s, z, c]]
        else:
            rows = [[c, -s, z], [s, c, z], [z, z, o]]
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    R = rot_axis(convention[0], angles[..., 0])
    for i, ax in enumerate(convention[1:], 1):
        R = R @ rot_axis(ax, angles[..., i])
    return R


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: first two rows flattened (Zhou et al.)."""
    return R[..., :2, :].reshape(R.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-12)
    a2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.norm(a2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)
