"""Splat -> mesh extraction: density grid + marching tetrahedra + OBJ
export (port of gaussianip_tpu/ops/mesh_extract.py).

  * density field: sum over gaussians of opacity * exp(-0.5 d^T Sigma^-1 d),
    gaussians kept at opacity > 0.005, the scene normalised to ~[-1, 1]
    (1.8 / its largest extent);
  * each gaussian scatter-adds its contribution on a P^3 voxel patch
    around its centre (index_add_ into r^3 + 1 cells, the last one taking
    the voxels outside the grid), in blocks of gaussians so that memory
    stays bounded; the sums come in another order than the JAX package's
    scatter, so grid values may differ in their last bits;
  * the isosurface by marching tetrahedra (6-tetrahedra cube split) on the
    host, a numpy copy of the JAX package's loop, so that the same grid
    gives the same vertices in the same order and the same faces;
  * OBJ export."""

from __future__ import annotations

import os

import numpy as np
import torch

from .sh import C0 as SH_C0
from .transforms import build_covariance, strip_symmetric

SPLAT_BLOCK = 16384  # gaussians per scatter block (x P^3 voxels each)


def gaussian_3d_coeff(d: torch.Tensor, cov6: torch.Tensor) -> torch.Tensor:
    """exp(-0.5 d^T Sigma^-1 d) from the packed upper-triangle covariance
    (xx, xy, xz, yy, yz, zz)."""
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    det = (xx * yy * zz + 2 * xy * yz * xz
           - xx * yz ** 2 - yy * xz ** 2 - zz * xy ** 2)
    det = torch.clamp(det, min=1e-24)
    ixx = (yy * zz - yz ** 2) / det
    iyy = (xx * zz - xz ** 2) / det
    izz = (xx * yy - xy ** 2) / det
    ixy = (xz * yz - xy * zz) / det
    ixz = (xy * yz - xz * yy) / det
    iyz = (xy * xz - yz * xx) / det
    x, y, z = d.unbind(-1)
    power = -0.5 * (ixx * x * x + iyy * y * y + izz * z * z) \
        - ixy * x * y - ixz * x * z - iyz * y * z
    return torch.exp(torch.clamp(power, max=0.0))


def splat_grid(xyz: torch.Tensor, cov6: torch.Tensor, opacity: torch.Tensor,
               resolution: int, patch: int, rgb=None) -> torch.Tensor:
    """Scatter-add each gaussian's P^3 patch into a grid over [-1, 1]^3, in
    blocks of SPLAT_BLOCK gaussians: [R, R, R] of opacity-weighted
    densities, or with `rgb` [N, 3], [R, R, R, 4] of (premultiplied rgb,
    weight)."""
    r = resolution
    dev = xyz.device
    cell = 2.0 / (r - 1)
    half = patch // 2
    off = torch.arange(patch, device=dev) - half
    offs = torch.stack(torch.meshgrid(off, off, off, indexing="ij"),
                       -1).reshape(-1, 3)  # [P^3, 3]
    channels = 1 if rgb is None else 4
    grid = torch.zeros((r ** 3 + 1, channels), dtype=torch.float32,
                       device=dev)
    block = SPLAT_BLOCK
    for s in range(0, xyz.shape[0], block):
        c = xyz[s:s + block]
        # round half to even, as jnp.round
        center_idx = torch.round((c + 1.0) / cell).to(torch.int32)
        vox = center_idx[:, None, :] + offs[None].to(torch.int32)
        pts = vox.to(torch.float32) * cell - 1.0
        w = gaussian_3d_coeff(pts - c[:, None, :], cov6[s:s + block, None, :]
                              ) * opacity[s:s + block, None]
        in_bounds = ((vox >= 0) & (vox < r)).all(-1)
        flat = torch.where(
            in_bounds, (vox[..., 0] * r + vox[..., 1]) * r + vox[..., 2],
            r ** 3).to(torch.int64)
        vals = w[..., None]
        if rgb is not None:
            vals = torch.cat([rgb[s:s + block, None, :] * vals, vals], -1)
        vals = torch.where(in_bounds[..., None], vals, 0.0)
        grid.index_add_(0, flat.reshape(-1), vals.reshape(-1, channels))
    grid = grid[: r ** 3].reshape(r, r, r, channels)
    return grid[..., 0] if rgb is None else grid


def normalized_splats(gaussians, opacity_threshold: float = 0.005,
                      with_rgb: bool = False) -> dict:
    """The gaussians with opacity > threshold among the first n_active, in
    the frame normalised by 1.8 / their largest extent: xyz [N, 3], cov6
    [N, 6] and opacity [N] as float32 tensors on the state's device (and
    rgb [N, 3], the DC band's colour clipped to [0, 1]); center [3] and
    scale, host numpy as in the JAX package."""
    n = int(gaussians.n_active)
    host = lambda a: a[:n].detach().cpu().numpy()
    op = host(gaussians.get_opacity())[:, 0]
    keep = op > opacity_threshold
    xyz = host(gaussians.xyz)[keep]
    scales = host(gaussians.get_scaling())[keep]
    rots = host(gaussians.rotation)[keep]
    op = op[keep]
    mn, mx = xyz.min(0), xyz.max(0)
    center = (mn + mx) / 2
    scale = 1.8 / (mx - mn).max()
    dev = gaussians.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    cov = build_covariance(f32(scales * scale), f32(rots))
    out = {"xyz": f32((xyz - center) * scale), "cov6": strip_symmetric(cov),
           "opacity": f32(op), "center": center, "scale": float(scale)}
    if with_rgb:
        rgb = host(gaussians.f_dc)[:, 0][keep] * SH_C0 + 0.5
        out["rgb"] = f32(np.clip(rgb, 0.0, 1.0))
    return out


def extract_density_grid(gaussians, resolution: int = 128, patch: int = 8,
                         opacity_threshold: float = 0.005):
    """(grid [R, R, R] host numpy, center [3], scale): the field in the
    normalised frame; world points are pts / scale + center."""
    s = normalized_splats(gaussians, opacity_threshold)
    grid = splat_grid(s["xyz"], s["cov6"], s["opacity"], resolution, patch)
    return grid.cpu().numpy(), s["center"], s["scale"]


# 6-tetrahedra decomposition of a cube (corner indices 0..7, z fastest)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int32)


def marching_tetrahedra(grid: np.ndarray, iso: float):
    """Host-side marching tetrahedra. Returns (verts [V, 3] in grid index
    coords, faces [F, 3]); vertices are shared through a sorted edge key,
    in the order the crossing cubes (np.nonzero order) and their
    tetrahedra (_TETS order) first reach them."""
    r = grid.shape[0]
    # cube corner offsets (x, y, z), matching bit order 0..7
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)
    base = np.stack(np.meshgrid(np.arange(r - 1), np.arange(r - 1),
                                np.arange(r - 1), indexing="ij"), -1
                    ).reshape(-1, 3)  # [C, 3]
    corner_pos = base[:, None, :] + corners[None, :, :]  # [C, 8, 3]
    vals = grid[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]

    verts = []
    faces = []
    vert_cache = {}

    def edge_vertex(p0, p1, v0, v1):
        key = (tuple(p0), tuple(p1)) if tuple(p0) < tuple(p1) else (
            tuple(p1), tuple(p0))
        if key not in vert_cache:
            t = (iso - v0) / (v1 - v0 + 1e-12)
            t = min(max(t, 0.0), 1.0)
            vert_cache[key] = len(verts)
            verts.append(p0 + t * (p1 - p0))
        return vert_cache[key]

    inside = vals > iso
    # only cubes crossing the isosurface
    cross = inside.any(1) & (~inside.all(1))
    for ci in np.nonzero(cross)[0]:
        cp = corner_pos[ci].astype(np.float64)
        cv = vals[ci]
        for tet in _TETS:
            ti = inside[ci][tet]
            n_in = int(ti.sum())
            if n_in == 0 or n_in == 4:
                continue
            ins = [tet[k] for k in range(4) if ti[k]]
            outs = [tet[k] for k in range(4) if not ti[k]]
            if n_in == 1:
                a = ins[0]
                e = [edge_vertex(cp[a], cp[o], cv[a], cv[o]) for o in outs]
                faces.append(e)
            elif n_in == 3:
                a = outs[0]
                e = [edge_vertex(cp[i_], cp[a], cv[i_], cv[a]) for i_ in ins]
                faces.append(e[::-1])
            else:  # 2 in, 2 out -> quad as two triangles
                a, b_ = ins
                c, d = outs
                e_ac = edge_vertex(cp[a], cp[c], cv[a], cv[c])
                e_ad = edge_vertex(cp[a], cp[d], cv[a], cv[d])
                e_bc = edge_vertex(cp[b_], cp[c], cv[b_], cv[c])
                e_bd = edge_vertex(cp[b_], cp[d], cv[b_], cv[d])
                faces.append([e_ac, e_ad, e_bd])
                faces.append([e_ac, e_bd, e_bc])
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    return np.stack(verts), np.asarray(faces, np.int32)


def extract_mesh(gaussians, resolution: int = 128, density_thresh: float = 1.0,
                 patch: int = 8):
    """Splats -> (verts [V, 3] world coords, faces [F, 3])."""
    grid, center, scale = extract_density_grid(gaussians, resolution, patch)
    verts, faces = marching_tetrahedra(grid, density_thresh)
    if len(verts):
        cell = 2.0 / (resolution - 1)
        verts = (verts * cell - 1.0) / scale + center
    return verts, faces


def save_obj(path: str, verts, faces):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
    return path
