"""Frozen copy of gaussianip_tpu_torch/render/preprocess.py, plain PyTorch.

Per-gaussian projection / culling / 2D covariance, batched over cameras
(port of gaussianip_tpu/render/preprocess.py).

EWA splatting as in the original 3DGS preprocess: projection, Jacobian-
clamped 2D covariance with +0.3 px dilation, 3-sigma radius, all written as
scalar formulas over [B, N] tensors. `mean2d_offset_ndc` is added to the NDC
xy before the pixel transform, so its gradient is the NDC viewspace
gradient the densification statistics read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.sh import eval_sh


class Projected(NamedTuple):
    mean2d: torch.Tensor  # [B, N, 2] pixel coords
    conic: torch.Tensor  # [B, N, 3] inverse 2D covariance (xx, xy, yy)
    color: torch.Tensor  # [B, N, 3]
    opacity: torch.Tensor  # [N]
    depth: torch.Tensor  # [B, N] view-space z
    radius: torch.Tensor  # [B, N] int32 3-sigma pixel radius (0 = culled)
    valid: torch.Tensor  # [B, N] bool
    radius_bin: torch.Tensor  # [B, N] int32 opacity-tightened radius
    radius_cull: torch.Tensor  # [B, N] int32 uncapped alpha>=1/255 radius


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(xyz, scales_act, quats, opacity_act, features, camera,
                      active_sh_degree: int, scaling_modifier=1.0,
                      mean2d_offset_ndc=None, override_color=None,
                      active_mask=None) -> Projected:
    """Project [N] gaussians (activated attributes) into [B] cameras."""
    x_, y_, z_ = (xyz[None, :, i] for i in range(3))  # [1, N]
    fp = camera.full_proj_t
    wv = camera.world_view_t
    m = lambda M, r, c: M[:, r, c, None]  # [B, 1]

    p_hom3 = x_ * m(fp, 0, 3) + y_ * m(fp, 1, 3) + z_ * m(fp, 2, 3) + m(fp, 3, 3)
    p_w = 1.0 / (p_hom3 + 1e-7)
    ndc_x = (x_ * m(fp, 0, 0) + y_ * m(fp, 1, 0) + z_ * m(fp, 2, 0)
             + m(fp, 3, 0)) * p_w
    ndc_y = (x_ * m(fp, 0, 1) + y_ * m(fp, 1, 1) + z_ * m(fp, 2, 1)
             + m(fp, 3, 1)) * p_w
    pv_x = x_ * m(wv, 0, 0) + y_ * m(wv, 1, 0) + z_ * m(wv, 2, 0) + m(wv, 3, 0)
    pv_y = x_ * m(wv, 0, 1) + y_ * m(wv, 1, 1) + z_ * m(wv, 2, 1) + m(wv, 3, 1)
    pv_z = x_ * m(wv, 0, 2) + y_ * m(wv, 1, 2) + z_ * m(wv, 2, 2) + m(wv, 3, 2)
    depth = pv_z
    in_front = depth > 0.2

    # 2D covariance via the clamped perspective Jacobian:
    # cov2d = A A^T with A = J @ R_cam @ L, L = R(q) diag(s)
    h, w = camera.height, camera.width
    tanx, tany = camera.tan_fovx[:, None], camera.tan_fovy[:, None]
    focal_x = w / (2.0 * tanx)
    focal_y = h / (2.0 * tany)
    tz = pv_z
    limx, limy = 1.3 * tanx, 1.3 * tany
    tx = torch.clamp(pv_x / tz, -limx, limx) * tz
    ty = torch.clamp(pv_y / tz, -limy, limy) * tz

    qn = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    qw, qx, qy, qz = qn.unbind(-1)
    s0 = scaling_modifier * scales_act[:, 0]
    s1 = scaling_modifier * scales_act[:, 1]
    s2 = scaling_modifier * scales_act[:, 2]
    L = (
        ((1 - 2 * (qy * qy + qz * qz)) * s0, 2 * (qx * qy - qw * qz) * s1,
         2 * (qx * qz + qw * qy) * s2),
        (2 * (qx * qy + qw * qz) * s0, (1 - 2 * (qx * qx + qz * qz)) * s1,
         2 * (qy * qz - qw * qx) * s2),
        (2 * (qx * qz - qw * qy) * s0, 2 * (qy * qz + qw * qx) * s1,
         (1 - 2 * (qx * qx + qy * qy)) * s2),
    )
    # B = R_cam @ L with R_cam = world_view_t[:3, :3].T
    Bm = tuple(
        tuple(m(wv, 0, i) * L[0][c] + m(wv, 1, i) * L[1][c]
              + m(wv, 2, i) * L[2][c] for c in range(3))
        for i in range(3))
    inv_tz = 1.0 / tz
    jx0 = focal_x * inv_tz
    jx2 = -(focal_x * tx) * inv_tz * inv_tz
    jy1 = focal_y * inv_tz
    jy2 = -(focal_y * ty) * inv_tz * inv_tz
    A0 = tuple(jx0 * Bm[0][c] + jx2 * Bm[2][c] for c in range(3))
    A1 = tuple(jy1 * Bm[1][c] + jy2 * Bm[2][c] for c in range(3))
    cxx = A0[0] * A0[0] + A0[1] * A0[1] + A0[2] * A0[2] + 0.3
    cyy = A1[0] * A1[0] + A1[1] * A1[1] + A1[2] * A1[2] + 0.3
    cxy = A0[0] * A1[0] + A0[1] * A1[1] + A0[2] * A1[2]

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], -1)

    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(lam1))
        # +0.2 margin keeps pixels whose f32 alpha rounds up across the
        # 1/255 gate inside the footprint
        q_max = 2.0 * torch.log(torch.clamp(opacity_act * 255.0,
                                            min=1e-12)) + 0.2
        sig_eff = torch.sqrt(torch.clamp(q_max, 0.0, 9.0))
        radius_bin_f = torch.ceil(sig_eff * torch.sqrt(lam1))
        radius_cull_f = torch.ceil(torch.sqrt(torch.clamp(q_max, min=0.0)
                                              * lam1))

        valid = in_front & det_ok
        if active_mask is not None:
            valid = valid & active_mask[None]
        zero = torch.zeros_like(radius_f)
        radius = torch.where(valid, radius_f, zero).to(torch.int32)
        valid = valid & (radius > 0)
        radius_bin = torch.where(valid, radius_bin_f, zero).to(torch.int32)
        valid = valid & (radius_bin > 0)
        radius_cull = torch.where(valid, radius_cull_f, zero).to(torch.int32)

    if mean2d_offset_ndc is not None:
        ndc_x = ndc_x + mean2d_offset_ndc[..., 0]
        ndc_y = ndc_y + mean2d_offset_ndc[..., 1]
    mean2d = torch.stack([ndc2pix(ndc_x, w), ndc2pix(ndc_y, h)], -1)

    # colours: SH eval toward the camera (clamped sh2rgb + 0.5 at 0)
    if override_color is not None:
        color = override_color.expand(mean2d.shape[0], -1, -1)
    else:
        dir_pp = xyz[None] - camera.camera_center[:, None, :]
        dir_pp = dir_pp / (torch.linalg.norm(dir_pp, dim=-1, keepdim=True)
                           + 1e-12)
        sh = features.transpose(-1, -2)[None]  # [1, N, 3, K]
        color = torch.clamp(eval_sh(active_sh_degree, sh, dir_pp) + 0.5,
                            min=0.0).expand(mean2d.shape[0], -1, -1)

    return Projected(mean2d, conic, color, opacity_act, depth, radius, valid,
                     radius_bin, radius_cull)


def tile_rect(mean2d, radius, tile: int, n_tiles_x: int, n_tiles_y: int):
    """Integer tile rectangle per gaussian: min inclusive, max exclusive,
    clamped to the grid."""
    r = radius.to(torch.float32)
    mx, my = mean2d[..., 0], mean2d[..., 1]
    fl = lambda v, hi: torch.clamp(torch.floor(v), 0, hi).to(torch.int64)
    return (fl((mx - r) / tile, n_tiles_x), fl((my - r) / tile, n_tiles_y),
            fl((mx + r + tile - 1) / tile, n_tiles_x),
            fl((my + r + tile - 1) / tile, n_tiles_y))


def gaussian_power_coeffs(mean2d_local, conic, opacity):
    """Quadratic-form coefficients of log(alpha) in local pixel coords:
    power(x, y) = a0 + ax x + ay y + axx x^2 + axy x y + ayy y^2, with a0
    absorbing log(opacity), so alpha = exp(power)."""
    mx, my = mean2d_local[..., 0], mean2d_local[..., 1]
    A, Bc, C = conic[..., 0], conic[..., 1], conic[..., 2]
    log_o = torch.log(torch.clamp(opacity, min=1e-12))
    a0 = log_o - 0.5 * (A * mx * mx + C * my * my) - Bc * mx * my
    ax = A * mx + Bc * my
    ay = C * my + Bc * mx
    return torch.stack([a0, ax, ay, -0.5 * A, -Bc, -0.5 * C], -1)
