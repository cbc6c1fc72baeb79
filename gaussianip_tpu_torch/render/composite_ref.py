"""Reference alpha compositor: plain differentiable PyTorch, dense per pixel
(port of gaussianip_tpu/render/composite_ref.py; the correctness oracle).

Alphas capped at 0.99, contributions below 1/255 skipped, front-to-back in
depth order, and a gaussian whose inclusion would drop transmittance below
1e-4 (with everything behind it) dropped, as the closed-form mask
w_i = alpha_i T_i [T_{i+1} >= 1e-4] over the unstopped cumulative product.
Background is composited by the caller. O(N * P): small scenes only.
"""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def composite_reference(mean2d, conic, color, opacity, depth, valid,
                        height: int, width: int, chunk: int = 256):
    """One camera: [N, ...] projected fields -> rgb [H, W, 3], depth [H, W],
    alpha [H, W]."""
    dev = mean2d.device
    inf = torch.full_like(depth, float("inf"))
    order = torch.argsort(torch.where(valid, depth, inf), stable=True)
    mean2d, conic, color = mean2d[order], conic[order], color[order]
    opacity, z, alive = opacity[order], depth[order], valid[order]

    py, px = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    pxf, pyf = px.reshape(-1), py.reshape(-1)
    p = height * width
    T = torch.ones(p, device=dev)
    acc_rgb = torch.zeros(p, 3, device=dev)
    acc_z = torch.zeros(p, device=dev)
    acc_a = torch.zeros(p, device=dev)
    for s in range(0, mean2d.shape[0], chunk):
        sl = slice(s, s + chunk)
        m, c_, col, o_, z_, ok = (mean2d[sl], conic[sl], color[sl],
                                  opacity[sl], z[sl], alive[sl])
        dx = m[:, 0:1] - pxf[None, :]
        dy = m[:, 1:2] - pyf[None, :]
        power = (-0.5 * (c_[:, 0:1] * dx * dx + c_[:, 2:3] * dy * dy)
                 - c_[:, 1:2] * dx * dy)
        alpha = torch.clamp(o_[:, None] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((alpha < ALPHA_MIN) | ~ok[:, None],
                            torch.zeros_like(alpha), alpha)
        t_incl = T[None, :] * torch.cumprod(1.0 - alpha, dim=0)
        t_excl = torch.cat([T[None, :], t_incl[:-1]], dim=0)
        w = alpha * t_excl * (t_incl >= T_EPS)
        acc_rgb = acc_rgb + w.T @ col
        acc_z = acc_z + (w * z_[:, None]).sum(0)
        acc_a = acc_a + w.sum(0)
        T = t_incl[-1]
    return (acc_rgb.reshape(height, width, 3), acc_z.reshape(height, width),
            acc_a.reshape(height, width))
