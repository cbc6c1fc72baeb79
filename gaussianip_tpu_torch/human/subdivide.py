"""SMPL mesh midpoint subdivision (port of
gaussianip_tpu/human/subdivide.py): each triangle becomes 4, attributes
(e.g. LBS weights) interpolate at the edge midpoints. numpy only."""

from __future__ import annotations

import numpy as np


def subdivide(verts: np.ndarray, faces: np.ndarray, attrs=None):
    """One midpoint subdivision: each triangle -> 4. Returns
    (new_verts, new_faces[, new_attrs])."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    edges_sorted = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)
    mid = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
    mid_idx = len(verts) + np.arange(len(uniq))
    new_verts = np.concatenate([verts, mid], axis=0)

    f = len(faces)
    e01 = mid_idx[inv[:f]]
    e12 = mid_idx[inv[f : 2 * f]]
    e20 = mid_idx[inv[2 * f :]]
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate([
        np.stack([v0, e01, e20], 1),
        np.stack([e01, v1, e12], 1),
        np.stack([e20, e12, v2], 1),
        np.stack([e01, e12, e20], 1),
    ], axis=0)

    if attrs is None:
        return new_verts, new_faces
    attrs = np.asarray(attrs)
    mid_attrs = 0.5 * (attrs[uniq[:, 0]] + attrs[uniq[:, 1]])
    return new_verts, new_faces, np.concatenate([attrs, mid_attrs], axis=0)


def subdivide_n(verts, faces, n: int = 1, attrs=None):
    for _ in range(n):
        out = subdivide(verts, faces, attrs)
        if attrs is None:
            verts, faces = out
        else:
            verts, faces, attrs = out
    return (verts, faces) if attrs is None else (verts, faces, attrs)
