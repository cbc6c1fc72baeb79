"""Frozen copy of gaussianip_tpu_torch/render/render.py, plain PyTorch.

Public splat-render API (port of gaussianip_tpu/render/render.py).

Given a GaussianState and a batch of cameras: rgb / depth / alpha images,
per-gaussian screen radii and, through `mean2d_offset`, the NDC viewspace
gradient hook for the densification statistics. The pipeline is
project -> bin -> composite (the [B, N, 10] per-gaussian attributes through
the gather + pack and K1 / K2 on CUDA tensors) -> background. The
per-instance -> per-gaussian gradient reduction is fused into K2's
atomics (on CPU tensors, autograd of the gather in the plain backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .binning import bin_instances
from .composite_cuda import composite_tiles, tiles_to_image
from .preprocess import project_gaussians


@dataclass(frozen=True)
class RenderConfig:
    tile: int = 16
    # pool sizes round up to a multiple of `chunk` (as in the JAX package,
    # so pool sizes and n_dropped agree)
    chunk: int = 128
    d_max: int = 25
    pool: int = 0  # 0 = auto
    inline: int = 1  # inline instance slots per gaussian before the pool
    # within-tile depth order carrier: "q16", "exact2" or "rank"
    # (binning.bin_instances)
    depth_key: str = "q16"
    sort_stable: bool = False
    # circle-vs-tile-rect instance cull (output preserving, see binning)
    tile_cull: bool = True


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [B, H, W, 3]
    depth: torch.Tensor  # [B, H, W] alpha-weighted view-z
    alpha: torch.Tensor  # [B, H, W]
    radii: torch.Tensor  # [B, N] int32
    n_dropped: torch.Tensor  # [B] instances lost to pool overflow


def _auto_pool(n: int, chunk: int, h: int, w: int, inline: int = 1,
               tile: int = 16, d_max: int = 25) -> int:
    """Overflow-pool size: extras beyond the inline tier scale with
    resolution^2 (~1.25x the measured extras); tiny renders (<= 64 tiles)
    get the exact worst case."""
    nt = -(-w // tile) * -(-h // tile)
    worst = n * max(min(d_max, nt) - inline, 1)
    if nt <= 64:
        pool = worst
    else:
        res_scale = max((h * w) / float(1024 * 1024), 0.05)
        pool = min(worst,
                   max(int((3.5 - 0.35 * (inline - 1)) * n * res_scale),
                       2 * n, 2 * chunk))
    return -(-max(pool, 2 * chunk) // chunk) * chunk


def _project(gaussians, cameras, mean2d_offset, scaling_modifier,
             override_color, active_sh_degree):
    deg = (gaussians.active_sh_degree if active_sh_degree is None
           else active_sh_degree)
    return project_gaussians(
        gaussians.xyz, gaussians.get_scaling(), gaussians.rotation,
        gaussians.get_opacity()[:, 0], gaussians.get_features(), cameras,
        deg, scaling_modifier, mean2d_offset, override_color,
        gaussians.active_mask())


def _bin(proj, cameras, n: int, cfg: RenderConfig):
    h, w = cameras.height, cameras.width
    ntx, nty = -(-w // cfg.tile), -(-h // cfg.tile)
    pool = cfg.pool or _auto_pool(n, cfg.chunk, h, w, cfg.inline, cfg.tile,
                                  cfg.d_max)
    binning = bin_instances(
        proj.mean2d.detach(), proj.radius_bin, proj.depth.detach(),
        proj.valid, proj.radius_cull, tile=cfg.tile, n_tiles_x=ntx,
        n_tiles_y=nty, d_max=cfg.d_max, pool=pool, inline=cfg.inline,
        depth_key=cfg.depth_key, sort_stable=cfg.sort_stable,
        tile_cull=cfg.tile_cull)
    return binning, ntx, nty


def _pack(proj, cameras, n: int, cfg: RenderConfig):
    """Bin, and stack the compositor's per-gaussian attributes
    packed [B, N, 10]: mean2d, conic, opacity, colour, depth."""
    b = proj.depth.shape[0]
    binning, ntx, nty = _bin(proj, cameras, n, cfg)
    opac = proj.opacity[None].expand(b, n)
    packed = torch.cat([proj.mean2d, proj.conic, opac[..., None],
                        proj.color, proj.depth[..., None]], -1)
    return packed, binning, ntx, nty


def render(gaussians, cameras, bg_color, cfg: RenderConfig = RenderConfig(),
           mean2d_offset: Optional[torch.Tensor] = None,
           scaling_modifier: float = 1.0, override_color=None,
           active_sh_degree: Optional[int] = None) -> RenderOutput:
    """Render a GaussianState into a batch of cameras.

    bg_color: [3]. mean2d_offset: optional [B, N, 2] zeros whose gradient is
    the NDC viewspace gradient used by the densification statistics.
    """
    n = gaussians.capacity
    h, w = cameras.height, cameras.width
    proj = _project(gaussians, cameras, mean2d_offset, scaling_modifier,
                    override_color, active_sh_degree)
    bgc = torch.as_tensor(bg_color, dtype=torch.float32,
                          device=gaussians.device)

    packed, binning, ntx, nty = _pack(proj, cameras, n, cfg)
    out = composite_tiles(packed, binning.gidx, binning.tile_of,
                          binning.starts, binning.counts, ntx, nty, cfg.tile)
    rgb, depth, alpha = tiles_to_image(out, nty, ntx, cfg.tile, h, w)
    rgb = rgb + bgc * (1.0 - alpha[..., None])
    return RenderOutput(rgb, depth, alpha, proj.radius, binning.n_dropped)
