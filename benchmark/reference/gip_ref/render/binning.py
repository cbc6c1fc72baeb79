"""Frozen copy of gaussianip_tpu_torch/render/binning.py, plain PyTorch.

Tile binning: gaussians -> depth-ordered per-tile instance segments,
batched over cameras (port of gaussianip_tpu/render/binning.py).

Same result contract as the JAX package:
  * two-tier duplication: every gaussian gets `inline` instance slots;
    footprints beyond that draw contiguous slots from a shared overflow pool
    (exhaustion is counted in n_dropped); footprints are first clamped to a
    centred side x side tile window, side = floor(sqrt(d_max));
  * circle-vs-tile cull (`tile_cull`) with the uncapped alpha >= 1/255
    radius; the pool tier culls against the same 2-px quantized mean and
    255-capped radius as the JAX package (conservative by +1.5 px), so both
    give the same instance sets;
  * one key sort groups instances by (camera, tile) and orders them by the
    depth carrier within a tile; dead slots sort to each camera's tail;
  * segments stay unaligned: starts/counts per (camera, tile).
Integer work only, run without gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .preprocess import tile_rect


class Binning(NamedTuple):
    gidx: torch.Tensor  # [B, E] int64 gaussian index per instance (N = dead)
    tile_of: torch.Tensor  # [B, E] int64 tile per instance (NT = dead)
    starts: torch.Tensor  # [B, NT] int32 segment starts (unaligned)
    counts: torch.Tensor  # [B, NT] int32 live instances per tile
    n_dropped: torch.Tensor  # [B] int64 instances lost to pool overflow


def _depth_carrier(depth, valid, depth_key: str):
    """Per-gaussian within-tile order key in [0, 2^32), [B, N] int64."""
    if depth_key == "rank":
        inf = torch.full_like(depth, float("inf"))
        order = torch.argsort(torch.where(valid, depth, inf), dim=1,
                              stable=True)
        rank = torch.empty_like(order)
        ar = torch.arange(depth.shape[1], device=depth.device)
        rank.scatter_(1, order, ar.expand_as(order))
        return rank
    if depth_key == "q16":
        inf = torch.full_like(depth, float("inf"))
        dmin = torch.where(valid, depth, inf).amin(dim=1, keepdim=True)
        dmax = torch.where(valid, depth, -inf).amax(dim=1, keepdim=True)
        scale = 65535.0 / torch.clamp(dmax - dmin, min=1e-12)
        return torch.clamp(((depth - dmin) * scale).to(torch.int64), 0, 65535)
    if depth_key == "exact2":
        # IEEE-754 bits of a positive f32 are order-isomorphic to its value
        # (valid depths are > 0.2); dead gaussians are masked by the key
        return depth.to(torch.float32).view(torch.int32).to(torch.int64) \
            & 0xFFFFFFFF
    raise ValueError(f"unknown depth_key {depth_key!r}")


@torch.no_grad()
def bin_instances(mean2d, radius, depth, valid, radius_cull=None, *,
                  tile: int, n_tiles_x: int, n_tiles_y: int, d_max: int,
                  pool: int, inline: int = 1, depth_key: str = "q16",
                  sort_stable: bool = False,
                  tile_cull: bool = True) -> Binning:
    """Inputs are [B, N] projection fields (mean2d [B, N, 2]). Returns
    segments into a per-camera instance array of E = inline*N + pool slots.

    depth_key: "rank" (global depth rank), "exact2" (f32 depth bits) or
    "q16" (16-bit affine quantization, ties compose in sort order).
    """
    b, n = depth.shape
    dev = depth.device
    nt = n_tiles_x * n_tiles_y
    e = inline * n + pool
    if radius_cull is None:
        # culling against the 3-sigma-capped bbox radius would be lossy
        tile_cull = False
        radius_cull = radius
    radius = radius.to(torch.int64)
    radius_cull = radius_cull.to(torch.int64)

    tmin_x, tmin_y, tmax_x, tmax_y = tile_rect(mean2d, radius, tile,
                                               n_tiles_x, n_tiles_y)
    # footprints larger than the budget clamp to a centred side x side window
    side = max(int(d_max ** 0.5), 1)
    cx = torch.clamp((mean2d[..., 0] / tile).to(torch.int64), 0,
                     n_tiles_x - 1)
    cy = torch.clamp((mean2d[..., 1] / tile).to(torch.int64), 0,
                     n_tiles_y - 1)
    big_x = (tmax_x - tmin_x) > side
    big_y = (tmax_y - tmin_y) > side
    tmin_x = torch.where(big_x, torch.clamp(cx - side // 2, 0,
                                            max(n_tiles_x - side, 0)), tmin_x)
    tmax_x = torch.where(big_x, torch.clamp(tmin_x + side, max=n_tiles_x),
                         tmax_x)
    tmin_y = torch.where(big_y, torch.clamp(cy - side // 2, 0,
                                            max(n_tiles_y - side, 0)), tmin_y)
    tmax_y = torch.where(big_y, torch.clamp(tmin_y + side, max=n_tiles_y),
                         tmax_y)
    w = tmax_x - tmin_x
    h = tmax_y - tmin_y
    count = torch.clamp(torch.where(valid, w * h, torch.zeros_like(w)),
                        max=d_max)
    sub = _depth_carrier(depth, valid, depth_key)

    # pool allocation: gaussian g draws extra_eff contiguous slots at
    # pool_ofs (exclusive cumsum); an exhausted pool truncates (counted)
    extra = torch.clamp(count - inline, min=0)
    csum = torch.cumsum(extra, dim=1)
    pool_ofs = csum - extra
    extra_eff = torch.minimum(torch.clamp(pool - pool_ofs, min=0), extra)
    n_dropped = (extra - extra_eff).sum(dim=1)
    w_safe = torch.clamp(w, min=1)

    def circle_ok(tx, ty, mx, my, r2):
        # circle(mean2d, radius) vs the tile's pixel rect
        lo_x = (tx * tile).to(torch.float32)
        lo_y = (ty * tile).to(torch.float32)
        ddx = mx - torch.minimum(torch.maximum(mx, lo_x), lo_x + (tile - 1))
        ddy = my - torch.minimum(torch.maximum(my, lo_y), lo_y + (tile - 1))
        return ddx * ddx + ddy * ddy <= r2

    # tier 1: inline slots, [B, N, inline]
    d_in = torch.arange(inline, device=dev)
    tx_in = tmin_x[..., None] + d_in % w_safe[..., None]
    ty_in = tmin_y[..., None] + d_in // w_safe[..., None]
    tile_in = ty_in * n_tiles_x + tx_in
    ok_in = d_in < torch.clamp(count, max=inline)[..., None]
    if tile_cull:
        rad_f = radius_cull.to(torch.float32)
        ok_in = ok_in & circle_ok(tx_in, ty_in, mean2d[..., 0:1],
                                  mean2d[..., 1:2], (rad_f * rad_f)[..., None])
    gid_in = torch.arange(n, device=dev)[:, None].expand(n, inline)

    # tier 2: pool slots; owning gaussian = #(pool_ofs <= j) - 1
    j = torch.arange(pool, device=dev).expand(b, pool).contiguous()
    pg = torch.clamp(torch.searchsorted(pool_ofs, j, right=True) - 1, 0,
                     n - 1)
    take = lambda a: torch.gather(a, 1, pg)
    seg_start = take(pool_ofs)
    s_total = torch.clamp(csum[:, -1:], max=pool)
    ok_pool = j < s_total
    aw = take(w_safe)
    d_pool = torch.clamp(inline + (j - seg_start), max=d_max)
    ptmin_x, ptmin_y = take(tmin_x), take(tmin_y)
    tx_p = ptmin_x + d_pool % aw
    ty_p = ptmin_y + d_pool // aw
    tile_p = ty_p * n_tiles_x + tx_p
    if tile_cull:
        # 2-px rounded mean offsets from the tmin corner and the 255-capped
        # radius, +1.5 px quantization slack (255 disables the cull)
        def q8(m, t0):
            return torch.clamp(((m - (t0 * tile).to(torch.float32)) * 0.5
                                + 0.5).to(torch.int64), 0, 255)
        fx8 = take(q8(mean2d[..., 0], tmin_x))
        fy8 = take(q8(mean2d[..., 1], tmin_y))
        radp = take(torch.clamp(radius_cull, max=255))
        rpf = radp.to(torch.float32) + 1.5
        mx_p = (ptmin_x * tile + fx8 * 2).to(torch.float32)
        my_p = (ptmin_y * tile + fy8 * 2).to(torch.float32)
        ok_pool = ok_pool & ((radp >= 255)
                             | circle_ok(tx_p, ty_p, mx_p, my_p, rpf * rpf))

    # one sort over all cameras: key = (camera, tile) << 32 | depth carrier
    tiles = torch.cat([tile_in.reshape(b, -1), tile_p], 1)  # [B, E]
    ok = torch.cat([ok_in.reshape(b, -1), ok_pool], 1)
    tiles = torch.where(ok, tiles, torch.full_like(tiles, nt))
    subs = torch.cat([sub[..., None].expand(b, n, inline).reshape(b, -1),
                      take(sub)], 1)
    cam = torch.arange(b, device=dev)[:, None] * (nt + 1)
    keys = ((cam + tiles) << 32) | subs
    _, order = torch.sort(keys.view(-1), stable=sort_stable)
    gid_all = torch.cat([gid_in.reshape(1, -1).expand(b, -1), pg], 1)
    # camera c's instances land in block c of the sorted order
    order = order.view(b, e) - torch.arange(b, device=dev)[:, None] * e
    tile_sorted = torch.gather(tiles, 1, order)
    live = tile_sorted != nt
    gidx = torch.where(live, torch.gather(gid_all, 1, order),
                       torch.full_like(tile_sorted, n))

    bounds = torch.searchsorted(
        tile_sorted,
        torch.arange(nt + 1, device=dev).expand(b, nt + 1).contiguous())
    starts = bounds[:, :nt]
    counts = bounds[:, 1:] - starts
    return Binning(gidx=gidx, tile_of=tile_sorted,
                   starts=starts.to(torch.int32).contiguous(),
                   counts=counts.to(torch.int32).contiguous(),
                   n_dropped=n_dropped)
