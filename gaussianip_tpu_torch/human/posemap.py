"""OpenPose skeleton-map rendering, batched over cameras, and the HumanSD
COCO-17 map (port of gaussianip_tpu/human/posemap.py: openpose_draw,
occlusion_mask and humansd_draw).

Project the 18 keypoints by the MVP, apply the azimuth/depth occlusion
rules, draw radius-4 coloured circles and ellipse limbs with the 0.4/0.6
blend, as an analytic rasterization over the pixel grid.
"""

from __future__ import annotations

import colorsys

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


# ---------------------------------------------------------------------------
# HumanSD variant: 17 COCO keypoints, 16 thick limb lines in an HLS palette,
# endpoint dots, painter's-order overwrite (no blending).

# COCO-17 selected from the OpenPose-18 keypoints (the neck dropped)
_HUMANSD17_FROM_OP18 = np.array(
    [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10], np.int64)

# [colour index, a, b] per limb, in drawing order
_HUMANSD_EDGES = np.array([
    [1, 0, 1], [0, 0, 2], [3, 1, 3], [2, 2, 4], [5, 3, 5], [4, 4, 6],
    [7, 5, 7], [6, 6, 8], [9, 7, 9], [8, 8, 10], [11, 5, 11], [10, 6, 12],
    [13, 11, 13], [12, 12, 14], [15, 13, 15], [14, 14, 16],
], np.int64)


def _hls_palette(n: int):
    """seaborn.color_palette("hls", n): evenly spaced hues offset by 0.01,
    lightness 0.6, saturation 0.65."""
    hues = (np.linspace(0, 1, n + 1)[:-1] + 0.01) % 1.0
    return np.array([colorsys.hls_to_rgb(h, 0.6, 0.65) for h in hues],
                    np.float32)


_HUMANSD_COLORS = np.floor(_hls_palette(len(_HUMANSD_EDGES)) * 255.0) / 255.0


def humansd_draw(points3d, mvp, height: int, width: int,
                 enable_occlusion: bool = False):
    """HumanSD-style COCO-17 skeleton map. points3d: [18, 3] OpenPose-18
    world keypoints (the COCO subset is selected here); mvp: [4, 4].
    Returns (canvas [H, W, 3], kp [1, 17, 3] (x, y, conf)). x is scaled by
    H and y by W, as the reference does; the same for square maps."""
    dev = mvp.device
    pts18_h = torch.cat([points3d, torch.ones_like(points3d[:, :1])], 1)
    pts = (pts18_h @ mvp.T)[torch.as_tensor(_HUMANSD17_FROM_OP18,
                                            device=dev)]
    ndc = pts[:, :3] / pts[:, 3:]
    xs = (ndc[:, 0] + 1) / 2 * height
    ys = (ndc[:, 1] + 1) / 2 * width

    conf = list(torch.ones((17,), device=dev).unbind(0))
    if enable_occlusion:
        z = ndc[:, 2]
        left_view = (z[0] > z[3]) & (z[0] < z[4])
        right_view = (~left_view) & (z[0] < z[3]) & (z[0] > z[4])
        back_view = ((~left_view) & (~right_view) & (z[0] > z[3])
                     & (z[0] > z[4]))
        hide = lambda i, cond: torch.where(cond, 0.0, conf[i])
        conf[4] = hide(4, left_view)
        conf[2] = hide(2, left_view & (xs[2] > xs[1]))
        conf[3] = hide(3, right_view)
        conf[1] = hide(1, right_view & (xs[1] < xs[2]))
        for i in (0, 1, 2):
            conf[i] = hide(i, back_view)
    conf = torch.stack(conf)

    w_line = int(10 * height / 512)
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    canvas = torch.zeros((height, width, 3), device=dev)
    colors = torch.as_tensor(_HUMANSD_COLORS, device=dev)

    # integer-cast endpoints (cv2 semantics)
    ix = torch.floor(xs)
    iy = torch.floor(ys)
    half = w_line / 2.0
    rdot = float(w_line // 2)
    for idx, a, b in _HUMANSD_EDGES.tolist():
        vis = (conf[a] > 0.3) & (conf[b] > 0.3)
        ax, ay, bx, by = ix[a], iy[a], ix[b], iy[b]
        # a capsule of radius w/2 around segment ab (cv2's thick line and
        # the two endpoint circles of radius w // 2)
        dx, dy = bx - ax, by - ay
        len2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
        t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / len2, 0.0, 1.0)
        qx = ax + t * dx
        qy = ay + t * dy
        d2 = (px - qx) ** 2 + (py - qy) ** 2
        inside = (d2 <= half * half) & vis
        dot = ((((px - ax) ** 2 + (py - ay) ** 2) <= rdot * rdot)
               | (((px - bx) ** 2 + (py - by) ** 2) <= rdot * rdot))
        inside = inside | (dot & vis)
        canvas = torch.where(inside[..., None], colors[idx], canvas)

    kp = torch.cat([torch.stack([xs, ys], 1), conf[:, None]], 1)[None]
    return canvas, kp
