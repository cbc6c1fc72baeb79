"""Point -> triangle-mesh closest-point queries (port of
gaussianip_tpu/ops/triangle.py): the binding of an avatar's gaussians to
the SMPL-X surface. It runs once per avatar, as a blocked brute-force
argmin over faces with Ericson's branch-free point-triangle region test.

The JAX package scans face blocks with all points at once, [P, Fb]
temporaries that XLA fuses; eager PyTorch materialises each, so the port
blocks over points as well (`point_block`). Each point's answer is
independent of the others, so the blocking does not change it. Within a
point block the face blocks run in order with the JAX merge: the earliest
face wins a tie.

Sign convention: positive when the point lies on the face-normal side.
"""

from __future__ import annotations

import torch


def closest_point_barycentric(p, a, b, c):
    """Barycentric coords (u, v, w) of the closest point on triangle (a,b,c)
    to p, branch-free (Ericson, Real-Time Collision Detection 5.1.5).
    All inputs broadcastable [..., 3]; returns [..., 3] barycentrics."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    eps = 1e-20

    def safe_div(x, y):
        return x / torch.where(torch.abs(y) < eps, eps, y)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # candidate barycentrics per region
    v_ab = torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0)
    w_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v_face = vb * denom
    w_face = vc * denom
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def bary(u, v, w):
        return torch.stack([u, v, w], -1)

    out = bary(1.0 - v_face - w_face, v_face, w_face)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    out = torch.where(in_bc[..., None], bary(zero, 1.0 - w_bc, w_bc), out)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = torch.where(in_ac[..., None], bary(1.0 - w_ac, zero, w_ac), out)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = torch.where(in_ab[..., None], bary(1.0 - v_ab, v_ab, zero), out)
    in_c = (d6 >= 0) & (d5 <= d6)
    out = torch.where(in_c[..., None], bary(zero, zero, one), out)
    in_b = (d3 >= 0) & (d4 <= d3)
    out = torch.where(in_b[..., None], bary(zero, one, zero), out)
    in_a = (d1 <= 0) & (d2 <= 0)
    out = torch.where(in_a[..., None], bary(one, zero, zero), out)
    return out


def _closest_faces(points, verts, faces, face_block: int):
    """(d2, face, uvw) of one block of points against every face, the face
    blocks merged in order with a strict `<` (the earliest face wins)."""
    p = points[:, None, :]
    best_d2 = torch.full((points.shape[0],), float("inf"),
                         device=points.device)
    best_f = torch.zeros((points.shape[0],), dtype=torch.int64,
                         device=points.device)
    best_uvw = torch.zeros((points.shape[0], 3), device=points.device)
    for s in range(0, faces.shape[0], face_block):
        fb = faces[s:s + face_block]
        a, b, c = (verts[fb[:, i]][None] for i in range(3))  # [1, Fb, 3]
        uvw = closest_point_barycentric(p, a, b, c)  # [Pb, Fb, 3]
        cp = uvw[..., 0:1] * a + uvw[..., 1:2] * b + uvw[..., 2:3] * c
        d2 = torch.sum((p - cp) ** 2, -1)  # [Pb, Fb]
        am = torch.argmin(d2, dim=1)  # the first minimum
        cand_d2 = torch.gather(d2, 1, am[:, None])[:, 0]
        cand_uvw = torch.gather(uvw, 1, am[:, None, None].expand(-1, 1, 3))
        better = cand_d2 < best_d2
        best_d2 = torch.where(better, cand_d2, best_d2)
        best_f = torch.where(better, s + am, best_f)
        best_uvw = torch.where(better[:, None], cand_uvw[:, 0], best_uvw)
    return best_d2, best_f, best_uvw


@torch.no_grad()
def signed_distance_to_mesh(points, verts, faces, face_block: int = 1024,
                            point_block: int = 8192):
    """For each point: (signed_dist [P], face_idx [P] int64, uvw [P, 3]) of
    the closest mesh triangle. points [P, 3]; verts [V, 3]; faces [F, 3]
    (integer tensor or array, on the points' device)."""
    points = points.to(torch.float32)
    verts = verts.to(torch.float32)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=points.device)
    parts = [_closest_faces(points[s:s + point_block], verts, faces,
                            face_block)
             for s in range(0, points.shape[0], point_block)]
    d2, fi, uvw = (torch.cat(x) for x in zip(*parts))

    fa = faces[fi]
    a, b, c = verts[fa[:, 0]], verts[fa[:, 1]], verts[fa[:, 2]]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-20)
    cp = uvw[:, 0:1] * a + uvw[:, 1:2] * b + uvw[:, 2:3] * c
    sign = torch.sign(torch.sum((points - cp) * n, -1))
    sign = torch.where(sign == 0, 1.0, sign)
    return sign * torch.sqrt(torch.clamp(d2, min=0.0)), fi, uvw
