"""Frozen copy of gaussianip_tpu_torch/human/posemap.py, plain PyTorch.

OpenPose skeleton-map rendering, batched over cameras (port of
gaussianip_tpu/human/posemap.py: openpose_draw and occlusion_mask).

Project the 18 keypoints by the MVP, apply the azimuth/depth occlusion
rules, draw radius-4 coloured circles and ellipse limbs with the 0.4/0.6
blend, as an analytic rasterization over the pixel grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .skeleton import OPENPOSE18_COLORS, OPENPOSE18_LINES

_COLORS = OPENPOSE18_COLORS / 255.0
# head-zoom visible set: nose, neck, r_elbow, l_elbow, eyes, ears
_HEAD_ZOOM_VIS = np.zeros(18, bool)
_HEAD_ZOOM_VIS[[0, 1, 3, 6, 14, 15, 16, 17]] = True


def occlusion_mask(points_ndc, xs, ys, azimuth_deg, head_zoom, height: int,
                   width: int):
    """Visibility per keypoint, [B, 18]. points_ndc: [B, 18, 3]; xs, ys:
    [B, 18]; azimuth_deg: [B] degrees; head_zoom: [B] bool."""
    mask = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    hz_vis = torch.as_tensor(_HEAD_ZOOM_VIS, device=xs.device)
    mask = torch.where(head_zoom[:, None], hz_vis[None, :], mask)
    m = list(mask.unbind(1))

    az = azimuth_deg
    m[16] = m[16] & ~((az > 0) & (az < 60))
    m[17] = m[17] & ~((az > 120) & (az < 180))

    z = points_ndc[..., 2]
    left_view = (z[:, 0] > z[:, 17]) & (z[:, 0] < z[:, 16])
    right_view = (~left_view) & (z[:, 0] < z[:, 17]) & (z[:, 0] > z[:, 16])
    back_view = ((~left_view) & (~right_view) & (z[:, 0] > z[:, 17])
                 & (z[:, 0] > z[:, 16]))

    m[16] = m[16] & ~left_view
    m[14] = m[14] & ~left_view & ~back_view
    m[15] = m[15] & ~(left_view & (az < 0))

    m[17] = m[17] & ~right_view
    m[15] = m[15] & ~right_view & ~back_view
    m[14] = m[14] & ~(right_view & (az < 0) & (az != -180.0))

    m[0] = m[0] & ~back_view
    return torch.stack(m, 1)


def openpose_draw(points3d, mvp, azimuth_deg, head_zoom, height: int,
                  width: int):
    """points3d: [18, 3] world keypoints; mvp: [B, 4, 4] (threestudio GL
    convention). Returns (canvas [B, H, W, 3], all_vis [B] {0,1},
    kps2d [B, 18, 2])."""
    dev = mvp.device
    b = mvp.shape[0]
    pts_h = torch.cat([points3d, torch.ones_like(points3d[:, :1])], 1)
    proj = pts_h[None] @ mvp.transpose(-1, -2)  # [B, 18, 4]
    ndc = proj[..., :3] / proj[..., 3:]
    xs = (ndc[..., 0] + 1) / 2 * width
    ys = (ndc[..., 1] + 1) / 2 * height
    mask = occlusion_mask(ndc, xs, ys, azimuth_deg, head_zoom, height, width)

    colors = torch.as_tensor(_COLORS, dtype=torch.float32, device=dev)
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    canvas = torch.zeros((b, height, width, 3), device=dev)
    bb = lambda v: v[:, None, None]  # [B] -> [B, 1, 1]

    # circles, radius 4, integer-cast centres
    cx = torch.floor(xs)
    cy = torch.floor(ys)
    for i in range(18):
        inside = ((px - bb(cx[:, i])) ** 2 + (py - bb(cy[:, i])) ** 2) <= 16.0
        inside = inside & bb(mask[:, i])
        canvas = torch.where(inside[..., None], colors[i], canvas)

    # ellipse limbs blended 0.4 old + 0.6 colour
    for i in range(len(OPENPOSE18_LINES)):
        a_idx, b_idx = int(OPENPOSE18_LINES[i, 0]), int(OPENPOSE18_LINES[i, 1])
        visible = mask[:, a_idx] & mask[:, b_idx]
        x0, x1 = xs[:, a_idx], xs[:, b_idx]
        y0, y1 = ys[:, a_idx], ys[:, b_idx]
        mX = torch.floor((x0 + x1) / 2)
        mY = torch.floor((y0 + y1) / 2)
        length = torch.sqrt((y0 - y1) ** 2 + (x0 - x1) ** 2)
        semi_a = torch.clamp(torch.floor(length / 2), min=1e-3)
        ang = torch.atan2(y0 - y1, x0 - x1)
        ca, sa = bb(torch.cos(ang)), bb(torch.sin(ang))
        dx = px - bb(mX)
        dy = py - bb(mY)
        xr = ca * dx + sa * dy
        yr = -sa * dx + ca * dy
        inside = (xr / bb(semi_a)) ** 2 + (yr / 4.0) ** 2 <= 1.0
        inside = inside & bb(visible)
        canvas = torch.where(inside[..., None],
                             0.4 * canvas + 0.6 * colors[i], canvas)

    all_vis = mask.all(dim=1).to(torch.float32)
    return canvas, all_vis, torch.stack([xs, ys], -1)
