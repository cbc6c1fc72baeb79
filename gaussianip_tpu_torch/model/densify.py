"""Densification / pruning as functional compactions over the padded
capacity (port of gaussianip_tpu/model/densify.py).

Semantics as in the JAX package: clone small hot gaussians, split large hot
ones into 2 children sampled N(mean, scale) rotated with scale/(0.8*2),
prune by opacity and world size; survivors keep their Adam moments, clones
and children start at zero; densify zeroes the stats, prune_only keeps them.
reset_opacity caps the opacities (the photo-reconstruction trainer's
periodic reset).
Output order is [kept originals, clones, split children]. The split noise is
an argument, so a caller (or a test) supplies the random draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.transforms import inverse_sigmoid, quat_to_rotmat
from .adam import AdamState
from .gaussians import PARAM_FIELDS, GaussianState, fresh_param_buffers


@dataclass
class DensifyStats:
    xyz_grad_accum: torch.Tensor  # [CAP]
    denom: torch.Tensor  # [CAP]
    max_radii2d: torch.Tensor  # [CAP] float


def init_stats(capacity: int, device="cuda") -> DensifyStats:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyStats(z(), z(), z())


@torch.no_grad()
def add_stats(stats: DensifyStats, viewspace_grad, radii, visibility):
    """viewspace_grad: [CAP, 2] summed over the camera batch (NDC units);
    radii: [CAP] max over cameras; visibility: [CAP] bool."""
    gnorm = torch.linalg.norm(viewspace_grad, dim=-1)
    vis = visibility.to(torch.float32)
    return DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.where(
            visibility,
            torch.maximum(stats.max_radii2d, radii.to(torch.float32)),
            stats.max_radii2d),
    )


def _scatter_group(dst: dict, src: dict, dest_idx, keep):
    """dst[f][dest_idx[keep]] = src[f][keep] for every field (in place)."""
    for f, buf in dst.items():
        buf[dest_idx[keep]] = src[f][keep]
    return dst


def _fresh(state: GaussianState) -> dict:
    return fresh_param_buffers(state.capacity, state.f_rest.shape[1],
                               state.device)


def _zeros_like_fields(d: dict) -> dict:
    return {f: torch.zeros_like(d[f]) for f in PARAM_FIELDS}


@torch.no_grad()
def densify_and_prune(state: GaussianState, opt: AdamState,
                      stats: DensifyStats, noise: torch.Tensor,
                      max_grad: float, min_opacity: float, extent: float,
                      max_world_size: float, percent_dense: float = 0.01):
    """Clone + split + prune. `noise`: [2, CAP, 3] standard normal draws for
    the split children. Returns (state, opt, stats, n_dropped)."""
    cap = state.capacity
    active = state.active_mask()
    grads = torch.where(stats.denom > 0,
                        stats.xyz_grad_accum / torch.clamp(stats.denom,
                                                           min=1e-12),
                        torch.zeros_like(stats.denom))
    grads = torch.nan_to_num(grads)

    scales = state.get_scaling()
    max_scale = scales.max(dim=1).values
    hot = active & (grads >= max_grad)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    opac = state.get_opacity()[:, 0]
    prune_vals = (opac < min_opacity) | (max_scale > max_world_size)
    child_scales = scales / (0.8 * 2.0)
    child_prune = (opac < min_opacity) | (
        child_scales.max(dim=1).values > max_world_size)

    o_keep = active & ~split_mask & ~prune_vals
    c_keep = clone_mask & ~prune_vals
    s_keep = split_mask & ~child_prune

    i32 = lambda m: m.to(torch.int64)
    n_o = int(i32(o_keep).sum())
    n_c = int(i32(c_keep).sum())
    n_s = int(i32(s_keep).sum())
    n_new = n_o + n_c + 2 * n_s

    pos_o = torch.cumsum(i32(o_keep), 0) - 1
    pos_c = n_o + torch.cumsum(i32(c_keep), 0) - 1
    base_s = n_o + n_c + 2 * (torch.cumsum(i32(s_keep), 0) - 1)

    params = {f: getattr(state, f) for f in PARAM_FIELDS}
    R = quat_to_rotmat(state.rotation)  # [CAP, 3, 3]
    child_xyz = state.xyz[None] + torch.einsum(
        "nij,cnj->cni", R, noise * scales[None])
    child_params = [
        {**params, "xyz": child_xyz[c], "scaling": torch.log(child_scales)}
        for c in range(2)
    ]

    # positions past the capacity drop out (the JAX scatter's mode="drop")
    fits = lambda pos, keep: keep & (pos < cap)
    new_params = _fresh(state)
    _scatter_group(new_params, params, pos_o, fits(pos_o, o_keep))
    _scatter_group(new_params, params, pos_c, fits(pos_c, c_keep))
    _scatter_group(new_params, child_params[0], base_s, fits(base_s, s_keep))
    _scatter_group(new_params, child_params[1], base_s + 1,
                   fits(base_s + 1, s_keep))

    new_m = _scatter_group(_zeros_like_fields(opt.m), opt.m, pos_o,
                           fits(pos_o, o_keep))
    new_v = _scatter_group(_zeros_like_fields(opt.v), opt.v, pos_o,
                           fits(pos_o, o_keep))

    n_dropped = max(n_new - cap, 0)
    new_state = state.replace(n_active=min(n_new, cap), **new_params)
    return (new_state, AdamState(m=new_m, v=new_v, count=opt.count),
            init_stats(cap, state.device), n_dropped)


@torch.no_grad()
def prune_only(state: GaussianState, opt: AdamState, stats: DensifyStats,
               min_opacity: float, max_world_size: float):
    """Opacity/world-size prune, keeping stats."""
    active = state.active_mask()
    opac = state.get_opacity()[:, 0]
    max_scale = state.get_scaling().max(dim=1).values
    keep = active & ~((opac < min_opacity) | (max_scale > max_world_size))
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    n_new = int(keep.sum())

    params = {f: getattr(state, f) for f in PARAM_FIELDS}
    new_params = _scatter_group(_fresh(state), params, pos, keep)
    new_m = _scatter_group(_zeros_like_fields(opt.m), opt.m, pos, keep)
    new_v = _scatter_group(_zeros_like_fields(opt.v), opt.v, pos, keep)
    new_stats = {}
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        z = torch.zeros_like(stats.denom)
        z[pos[keep]] = getattr(stats, f)[keep]
        new_stats[f] = z
    return (state.replace(n_active=n_new, **new_params),
            AdamState(m=new_m, v=new_v, count=opt.count),
            DensifyStats(**new_stats))


@torch.no_grad()
def reset_opacity(state: GaussianState, opt: AdamState,
                  ceiling: float = 0.01):
    """Cap the active opacities at `ceiling` and zero the opacity field's
    Adam moments. Returns (state, opt)."""
    op = torch.clamp(state.get_opacity(), max=ceiling)
    logit = inverse_sigmoid(torch.clamp(op, 1e-6, 1 - 1e-6))
    logit = torch.where(state.active_mask()[:, None], logit, state.opacity)
    m, v = dict(opt.m), dict(opt.v)
    m["opacity"] = torch.zeros_like(opt.m["opacity"])
    v["opacity"] = torch.zeros_like(opt.v["opacity"])
    return (state.replace(opacity=logit),
            AdamState(m=m, v=v, count=opt.count))
