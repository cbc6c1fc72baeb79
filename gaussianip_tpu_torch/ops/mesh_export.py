"""Textured OBJ/MTL export of trained gaussian avatars (port of
gaussianip_tpu/ops/mesh_export.py).

  * geometry: `ops.mesh_extract.extract_mesh` (density grid + marching
    tetrahedra);
  * appearance: the density grid's scatter-add also accumulates
    premultiplied DC colour into a [R, R, R, 4] field on the state's
    device; vertex colours are weight-normalised trilinear samples of it;
  * UV atlas: faces packed pairwise into uniform square cells, every cell
    sharing one canonical texel -> barycentric map (host numpy, as in the
    JAX package), so the bake is two einsums over faces;
  * the texture is always written as `<prefix>_albedo.png` by the port's
    own PNG encoder (the JAX package writes it with OpenCV, or a .npy
    without it)."""

from __future__ import annotations

import os

import numpy as np

from ..utils.saving import save_image
from .mesh_extract import extract_mesh, normalized_splats, save_obj, splat_grid


def splat_color_grid(gaussians, resolution: int = 128, patch: int = 8,
                     opacity_threshold: float = 0.005):
    """[R, R, R, 4] grid of (premultiplied rgb, weight) over the normalised
    [-1, 1]^3 frame (host numpy); returns (grid, center, scale) like
    extract_density_grid."""
    s = normalized_splats(gaussians, opacity_threshold, with_rgb=True)
    grid = splat_grid(s["xyz"], s["cov6"], s["opacity"], resolution, patch,
                      rgb=s["rgb"])
    return grid.cpu().numpy(), s["center"], s["scale"]


def _trilinear(grid: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Sample [R, R, R, C] at continuous grid-index coords [V, 3] (host)."""
    r = grid.shape[0]
    p = np.clip(pts, 0.0, r - 1 - 1e-6)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0)[..., None]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = ((f[:, 0] if dx else 1 - f[:, 0])
                       * (f[:, 1] if dy else 1 - f[:, 1])
                       * (f[:, 2] if dz else 1 - f[:, 2]))
                idx = np.minimum(i0 + [dx, dy, dz], r - 1)
                out = out + wgt * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def vertex_colors(gaussians, verts_world: np.ndarray, resolution: int = 128,
                  patch: int = 8) -> np.ndarray:
    """[V, 3] rgb in [0, 1]: the weight-normalised trilinear sample of the
    splatted colour field at the mesh vertices."""
    grid, center, scale = splat_color_grid(gaussians, resolution, patch)
    cell = 2.0 / (resolution - 1)
    pts = ((verts_world - center) * scale + 1.0) / cell
    s = _trilinear(grid, np.asarray(pts, np.float64))
    return np.clip(s[:, :3] / np.maximum(s[:, 3:4], 1e-8), 0.0, 1.0)


def _canonical_cell(k: int, margin: float):
    """The texel -> colour maps every cell of the atlas shares. Returns
    (bary_lower [k, k, 3], bary_upper [k, k, 3], uv_lower [3, 2], uv_upper
    [3, 2]) in cell-local texel units. Barycentrics are clamped and
    renormalised (edge dilation as seam padding) and masked to the half of
    the cell each triangle owns (texels below / above the anti-diagonal)."""
    m = margin
    tri_l = np.array([[m, m], [k - 2 * m, m], [m, k - 2 * m]], np.float64)
    tri_u = np.array([[k - m, k - m], [2 * m, k - m], [k - m, 2 * m]],
                     np.float64)
    xs, ys = np.meshgrid(np.arange(k) + 0.5, np.arange(k) + 0.5,
                         indexing="xy")
    p = np.stack([xs, ys], -1)  # [k, k, 2] (x right, y down in texel space)

    def bary(tri):
        a, b, c = tri
        t = np.array([[b[0] - a[0], c[0] - a[0]],
                      [b[1] - a[1], c[1] - a[1]]])
        uv = (p - a) @ np.linalg.inv(t).T  # [k, k, 2] = (beta, gamma)
        full = np.stack([1 - uv[..., 0] - uv[..., 1],
                         uv[..., 0], uv[..., 1]], -1)
        full = np.clip(full, 0.0, None)
        return full / np.maximum(full.sum(-1, keepdims=True), 1e-12)

    lower_mask = (xs + ys) <= k
    bl = bary(tri_l) * lower_mask[..., None]
    bu = bary(tri_u) * (~lower_mask)[..., None]
    return bl, bu, tri_l, tri_u


def pack_face_uvs(n_faces: int, texture_size: int = 1024,
                  margin: float = 1.5):
    """Pairwise square-cell atlas. Returns (face_uvs [F, 3, 2] in [0, 1],
    OBJ convention with v up; the cell spec bake_texture takes)."""
    n_cells = (n_faces + 1) // 2
    grid_n = int(np.ceil(np.sqrt(n_cells)))
    k = max(texture_size // max(grid_n, 1), 4)
    size = grid_n * k
    bl, bu, tri_l, tri_u = _canonical_cell(k, margin)

    cell_idx = np.arange(n_cells)
    cy, cx = cell_idx // grid_n, cell_idx % grid_n
    origin = np.stack([cx * k, cy * k], -1).astype(np.float64)  # [C, 2]

    face_uv_tex = np.empty((n_faces, 3, 2), np.float64)
    face_uv_tex[0::2] = origin[:, None, :] + tri_l[None]
    face_uv_tex[1::2] = origin[:n_faces // 2, None, :] + tri_u[None]
    # texel (x, y down) -> OBJ uv (u right, v up)
    uv = np.empty_like(face_uv_tex)
    uv[..., 0] = face_uv_tex[..., 0] / size
    uv[..., 1] = 1.0 - face_uv_tex[..., 1] / size
    spec = {"grid_n": grid_n, "k": k, "size": size, "n_cells": n_cells,
            "bary_lower": bl, "bary_upper": bu}
    return uv, spec


def bake_texture(face_vert_colors: np.ndarray, spec: dict) -> np.ndarray:
    """[size, size, 3] float texture from per-face corner colours
    [F, 3, 3]: lower- and upper-triangle faces through the shared
    barycentric maps."""
    f = face_vert_colors.shape[0]
    n_cells, grid_n, k = spec["n_cells"], spec["grid_n"], spec["k"]
    cols_l = np.zeros((n_cells, 3, 3))
    cols_l[: (f + 1) // 2] = face_vert_colors[0::2]
    cols_u = np.zeros((n_cells, 3, 3))
    cols_u[: f // 2] = face_vert_colors[1::2]
    cells = (np.einsum("yxb,fbc->fyxc", spec["bary_lower"], cols_l)
             + np.einsum("yxb,fbc->fyxc", spec["bary_upper"], cols_u))
    pad = grid_n * grid_n - n_cells
    if pad:
        cells = np.concatenate([cells, np.zeros((pad, k, k, 3))], 0)
    img = cells.reshape(grid_n, grid_n, k, k, 3).transpose(0, 2, 1, 3, 4)
    return img.reshape(grid_n * k, grid_n * k, 3)


def export_textured_obj(out_prefix: str, verts: np.ndarray, faces: np.ndarray,
                        vert_colors: np.ndarray, texture_size: int = 1024):
    """Write <prefix>.obj, .mtl and _albedo.png. Returns their paths."""
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    uv, spec = pack_face_uvs(len(faces), texture_size)
    tex = bake_texture(vert_colors[faces], spec)
    name = os.path.basename(out_prefix)
    tex_path = save_image(out_prefix + "_albedo.png",
                          (np.clip(tex, 0, 1) * 255 + 0.5).astype(np.uint8))
    mtl_path = out_prefix + ".mtl"
    with open(mtl_path, "w") as fh:
        fh.write("newmtl material_0\nKa 0 0 0\nKd 1 1 1\nKs 0 0 0\n"
                 f"map_Kd {os.path.basename(tex_path)}\n")
    obj_path = out_prefix + ".obj"
    with open(obj_path, "w") as fh:
        fh.write(f"mtllib {name}.mtl\n")
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for fuv in uv.reshape(-1, 2):
            fh.write(f"vt {fuv[0]:.6f} {fuv[1]:.6f}\n")
        fh.write("usemtl material_0\n")
        for i, tri in enumerate(faces):
            t = 3 * i
            fh.write(f"f {tri[0] + 1}/{t + 1} {tri[1] + 1}/{t + 2} "
                     f"{tri[2] + 1}/{t + 3}\n")
    return {"obj": obj_path, "mtl": mtl_path, "texture": tex_path}


def export_avatar_mesh(gaussians, out_prefix: str, resolution: int = 128,
                       density_thresh: float = 1.0, texture_size: int = 1024,
                       fmt: str = "obj-mtl"):
    """Trained GaussianState -> mesh files (the `--export` path): "obj-mtl"
    a textured OBJ/MTL/PNG, "obj" a plain OBJ. Raises ValueError when the
    extraction finds no surface."""
    verts, faces = extract_mesh(gaussians, resolution=resolution,
                                density_thresh=density_thresh)
    if len(verts) == 0:
        raise ValueError("mesh extraction produced no surface "
                         "(density_thresh too high?)")
    if fmt == "obj":
        return {"obj": save_obj(out_prefix + ".obj", verts, faces)}
    cols = vertex_colors(gaussians, verts, resolution=resolution)
    return export_textured_obj(out_prefix, verts, faces, cols,
                               texture_size=texture_size)
