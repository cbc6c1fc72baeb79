"""Frozen copy of gaussianip_tpu_torch/render/composite_cuda.py, plain PyTorch.

Tile compositor in plain PyTorch: the gather + pack of the per-gaussian
attributes, the forward per tile in instance chunks with a cumprod
transmittance, and the closed-form backward (the plain versions of
csrc/composite.cu's K1 and K2, which this copy never runs).

    packed [B, N, 10] f32 per-gaussian attributes: mean2d 0:2, conic 2:5,
           opacity 5, colour 6:9, depth 9 (the differentiable input).
    gidx, tile_of [B, E] i64: gaussian and tile of each instance slot
           (N and NT for dead slots), from binning.bin_instances.
    data   [B, 16, E] f32 (`pack_instances`): rows 0-5 power coefficients,
           rows 8-12 features [r, g, b, depth, 1]; rows 6-7, 13-15 zero.
    starts, counts [B, NT] i32: unaligned depth-sorted segment per tile.
    out    [B, NT, 8, tile*tile]: rows 0-2 rgb, 3 alpha-weighted depth,
           4 alpha, 5 last contributor (segment-relative, -1 = none), 6-7
           zero.

The backward is the closed form (not autograd of the forward): the
gradient of alpha is not gated at the 0.99 cap. It is pulled back to
d_packed by autograd of `pack_instances`.
"""

from __future__ import annotations

import torch

from .preprocess import gaussian_power_coeffs

# the 1/255 gate on alpha as both K1/K2 and the plain versions decide it:
# the power (the log of alpha) against ln(1/255) in float32
LOG_ALPHA_MIN = -5.5412636
ALPHA_MAX = 0.99
T_EPS = 1e-4
KERNEL_TILE = 16  # K1/K2 run 16x16 tiles


def _pixel_features(tile: int, like: torch.Tensor) -> torch.Tensor:
    """[6, P] rows 1, x, y, x^2, xy, y^2 (tile-local, p = y * tile + x)."""
    idx = torch.arange(tile * tile, device=like.device)
    x = (idx % tile).to(like.dtype)
    y = (idx // tile).to(like.dtype)
    return torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y])


def _power(c, featpix):
    """The power [BT, C, P] of coefficients c [6, BT, C] (rows a0 ax ay axx
    axy ayy) at the tile's pixels, evaluated as K1/K2 evaluate it, one
    rounding per operation: (a0 + x (ax + x axx)) + y ((ay + x axy) +
    y ayy). The 1/255 gate then falls on the same pixels as in the
    kernels."""
    a0, ax, ay, axx, axy, ayy = (t[..., None] for t in c)
    x, y = featpix[1], featpix[2]
    u = a0 + x * (ax + x * axx)
    v = ay + x * axy
    return u + y * (v + y * ayy)


def _live(power):
    """alpha >= 1/255, decided on the power as K1/K2 decide it."""
    return power >= power.new_tensor(LOG_ALPHA_MIN)


def pack_instances(packed, gidx, tile_of, n_tiles_x: int, n_tiles_y: int,
                   tile: int = 16) -> torch.Tensor:
    """Gather the 10 attributes of each instance's gaussian and pack the
    compositor's data [B, 16, E]; dead slots are zero. Differentiable in
    `packed` when autograd records it (the Function runs it without)."""
    n = packed.shape[1]
    rv = gidx < n  # [B, E]
    gidx_safe = torch.clamp(gidx, max=n - 1)
    inst = torch.gather(packed, 1, gidx_safe[..., None].expand(-1, -1, 10))
    tile_safe = torch.clamp(tile_of, max=n_tiles_x * n_tiles_y - 1)
    origin = torch.stack([(tile_safe % n_tiles_x) * tile,
                          (tile_safe // n_tiles_x) * tile], -1).to(
                              packed.dtype)
    coeff6 = gaussian_power_coeffs(inst[..., 0:2] - origin, inst[..., 2:5],
                                   inst[..., 5])
    z = torch.zeros_like(inst[..., 0])
    planes = [coeff6[..., i] for i in range(6)] + [z, z]
    planes += [inst[..., 6], inst[..., 7], inst[..., 8], inst[..., 9],
               rv.to(packed.dtype), z, z, z]
    data = torch.stack(planes, dim=1)  # [B, 16, E]
    return torch.where(rv[:, None, :], data, torch.zeros_like(data))


# ---------------------------------------------------------------- plain ---

def _segment_rows(data, starts, counts, k):
    """Gather rows of the instances at segment offsets k [C] of every tile:
    returns (flat index [BT, C], in-segment mask [BT, C], coeff [6, BT, C],
    feat [5, BT, C])."""
    b, _, e = data.shape
    flat = data.permute(1, 0, 2).reshape(16, b * e)
    base = (starts.to(torch.int64)
            + torch.arange(b, device=data.device)[:, None] * e).reshape(-1)
    ok = k[None, :] < counts.reshape(-1, 1).to(torch.int64)
    idx = torch.where(ok, base[:, None] + k[None, :], torch.zeros_like(ok,
                      dtype=torch.int64))
    return idx, ok, flat[0:6][:, idx], flat[8:13][:, idx]


def composite_fwd_plain(data, starts, counts, tile: int = 16,
                        chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch forward: per tile, instance chunks of `chunk` with a
    cumprod transmittance and the same gates as K1."""
    b, _, e = data.shape
    nt = starts.shape[1]
    p = tile * tile
    bt = b * nt
    dev = data.device
    featpix = _pixel_features(tile, data)
    like = dict(dtype=data.dtype, device=dev)
    T = torch.ones(bt, p, **like)
    acc = torch.zeros(bt, 5, p, **like)
    last = torch.full((bt, p), -1.0, **like)
    max_count = int(counts.max()) if counts.numel() else 0
    for k0 in range(0, max_count, chunk):
        k = torch.arange(k0, k0 + chunk, device=dev)
        _, ok, c, f = _segment_rows(data, starts, counts, k)
        power = _power(c, featpix)
        alpha = torch.clamp(torch.exp(power), max=ALPHA_MAX)
        live = ok[..., None] & _live(power)
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        t_incl = T[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([T[:, None, :], t_incl[:, :-1]], dim=1)
        contrib = (t_incl >= T_EPS) & (alpha > 0.0)
        w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
        acc += torch.einsum("fbc,bcp->bfp", f, w)
        kf = k.to(data.dtype)[None, :, None].expand_as(w)
        last = torch.maximum(last, torch.where(
            contrib, kf, torch.full_like(w, -1.0)).amax(dim=1))
        T = t_incl[:, -1]
    out = torch.zeros(bt, 8, p, **like)
    out[:, 0:5] = acc
    out[:, 5] = last
    return out.view(b, nt, 8, p)


def composite_bwd_plain(data, starts, counts, out, gout, tile: int = 16,
                        chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch backward, the closed form of K2 with flipped cumsums:
    T rebuilt from T_stop = 1 - alpha_out, walking chunks back from the
    last contributor. Returns dgrad [B, 16, E]."""
    b, _, e = data.shape
    nt = starts.shape[1]
    p = tile * tile
    bt = b * nt
    dev = data.device
    featpix = _pixel_features(tile, data)
    out = out.reshape(bt, 8, p)
    g = gout.reshape(bt, 8, p)[:, 0:5]
    last = out[:, 5]
    T = torch.clamp(1.0 - out[:, 4], min=1e-12)
    r = torch.zeros_like(T)
    dflat = torch.zeros(16, b * e, dtype=data.dtype, device=dev)
    max_last = int(last.max()) if last.numel() else -1
    for k0 in reversed(range(0, max_last + 1, chunk)):
        k = torch.arange(k0, k0 + chunk, device=dev)
        idx, ok, c, f = _segment_rows(data, starts, counts, k)
        power = _power(c, featpix)
        raw = torch.exp(power)
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        contrib = (ok[..., None] & _live(power)
                   & (k.to(data.dtype)[None, :, None] <= last[:, None, :]))
        zero = torch.zeros_like(alpha)
        om = torch.where(contrib, 1.0 - alpha, torch.ones_like(alpha))
        # suffix products within the chunk: prod_{j >= i} om_j
        suf = torch.flip(torch.cumprod(torch.flip(om, [1]), 1), [1])
        t_excl = T[:, None, :] / suf
        w = torch.where(contrib, alpha * t_excl, zero)
        t1 = torch.einsum("fbc,bfp->bcp", f, g)
        t1w = t1 * w
        incl = torch.flip(torch.cumsum(torch.flip(t1w, [1]), 1), [1])
        r_after = r[:, None, :] + incl - t1w  # later contributors only
        dalpha = torch.where(contrib, t1 * t_excl - r_after / om, zero)
        dpower = dalpha * raw  # not gated at the 0.99 cap
        dcoeff = torch.einsum("bcp,kp->kbc", dpower, featpix)
        dfeat = torch.einsum("bfp,bcp->fbc", g, w)
        sel = idx[ok]
        dflat[0:6, sel] = dcoeff[:, ok]
        dflat[8:13, sel] = dfeat[:, ok]
        T = t_excl[:, 0]
        r = r + incl[:, 0]
    return dflat.view(16, b, e).permute(1, 0, 2).contiguous()


def composite_bwd_gaussians_plain(data, packed, gidx, tile_of, starts,
                                  counts, out, gout, n_tiles_x: int,
                                  n_tiles_y: int,
                                  tile: int = 16) -> torch.Tensor:
    """K2's plain version: composite_bwd_plain's per-instance gradient,
    pulled back through pack_instances (the gather and
    gaussian_power_coeffs) by autograd into d_packed [B, N, 10]."""
    dgrad = composite_bwd_plain(data, starts, counts, out, gout, tile)
    with torch.enable_grad():
        leaf = packed.detach().requires_grad_(True)
        again = pack_instances(leaf, gidx, tile_of, n_tiles_x, n_tiles_y,
                               tile)
        (d_packed,) = torch.autograd.grad(again, leaf, dgrad)
    return d_packed


class _CompositeGaussians(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, gidx, tile_of, starts, counts, n_tiles_x,
                n_tiles_y, tile):
        data = pack_instances(packed, gidx, tile_of, n_tiles_x, n_tiles_y,
                              tile)
        ctx.grid = (n_tiles_x, n_tiles_y, tile)
        out = composite_fwd_plain(data, starts, counts, tile)
        ctx.save_for_backward(data, packed, gidx, starts, counts, out,
                              tile_of)
        return out

    @staticmethod
    def backward(ctx, gout):
        data, packed, gidx, starts, counts, out, tile_of = \
            ctx.saved_tensors
        ntx, nty, tile = ctx.grid
        gout = gout.contiguous()
        d_packed = composite_bwd_gaussians_plain(
            data, packed, gidx, tile_of, starts, counts, out, gout, ntx,
            nty, tile)
        return d_packed, None, None, None, None, None, None, None


def composite_tiles(packed, gidx, tile_of, starts, counts, n_tiles_x: int,
                    n_tiles_y: int, tile: int = 16) -> torch.Tensor:
    """Composite the depth-sorted instance segments of the gaussians in
    `packed` [B, N, 10] into per-tile accumulators [B, NT, 8, tile*tile];
    differentiable in `packed`."""
    return _CompositeGaussians.apply(packed, gidx, tile_of, starts, counts,
                                     n_tiles_x, n_tiles_y, tile)


def tiles_to_image(out, n_tiles_y: int, n_tiles_x: int, tile: int,
                   height: int, width: int):
    """[B, NT, 8, P] -> rgb [B, H, W, 3], depth [B, H, W], alpha [B, H, W]."""
    b = out.shape[0]
    img = out.reshape(b, n_tiles_y, n_tiles_x, 8, tile, tile)
    img = img.permute(0, 3, 1, 4, 2, 5)  # [B, 8, ty, tile, tx, tile]
    img = img.reshape(b, 8, n_tiles_y * tile, n_tiles_x * tile)
    img = img[:, :, :height, :width]
    return img[:, 0:3].permute(0, 2, 3, 1), img[:, 3], img[:, 4]
