"""LBS-weight-diffused avatar deformation (port of
gaussianip_tpu/human/lbs_deform.py). Each gaussian receives a smooth
transform by diffusing the SMPL-X vertices' LBS transforms through its
K = 6 nearest template vertices:

  conf_j = exp(-|lbs_w_j - lbs_w_nn0|_1 / (2 * 0.1^2)) > 0.5     (gate)
  w_j    = exp(-d_j^2) * conf_j, normalized over K (clamped at 1e-12)
  T_gau  = sum_j w_j * T_vert_j

with d_j^2 the squared nearest-neighbour distance, and the canonical ->
posed chain removing and reapplying the blend shapes:

  T_a2pose = T_pose @ (inv(T_t2a) + [0 | canonical_offsets - curr_offsets])

Means transform by T, rotations by quat(R_T) * q; scales stay. A point
far from every template vertex (a padded row) gets T = 0.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn_dist2
from ..ops.rotations import quat_multiply, rotmat_to_quat
from .smplx import SMPLXParams, smplx_forward


def lbs_diffuse_transforms(lbs_weights, verts_transform, points,
                           template_points, K: int = 6,
                           weight_std: float = 0.1,
                           conf_threshold: float = 0.5) -> torch.Tensor:
    """Per-point blended transforms [N, 4, 4]."""
    d2, idx = knn_dist2(points, template_points, k=K)
    nn_lbs = lbs_weights[idx]  # [N, K, J]
    conf = torch.exp(-torch.sum(torch.abs(nn_lbs - nn_lbs[:, 0:1, :]), -1)
                     / (2.0 * weight_std ** 2))
    conf = (conf > conf_threshold).to(torch.float32)
    w = torch.exp(-d2) * conf
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    nn_T = verts_transform[idx]  # [N, K, 4, 4]
    return torch.sum(w[..., None, None] * nn_T, dim=1)


def a2pose_transforms(params: SMPLXParams, inv_T_t2a, canonical_offsets,
                      **pose) -> torch.Tensor:
    """Per-vertex canonical -> posed transforms [V, 4, 4] for the pose
    (smplx_forward's keyword arguments)."""
    out = smplx_forward(params, **pose)
    curr_offsets = out.shape_offsets + out.pose_offsets
    T_a2t = inv_T_t2a.clone()
    T_a2t[:, :3, 3] += canonical_offsets - curr_offsets
    return out.vertex_transforms @ T_a2t


def deform_points(T, xyz, rotation):
    """(xyz', rotation') of rows under their transforms T [N, 4, 4]."""
    xyz_h = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    new_xyz = torch.einsum("nab,nb->na", T, xyz_h)[:, :3]
    return new_xyz, quat_multiply(rotmat_to_quat(T[:, :3, :3]), rotation)


class LBSDeformer:
    """Canonical (A-pose) gaussians -> target pose via LBS diffusion."""

    def __init__(self, params: SMPLXParams, canonical_body_pose=None):
        self.params = params
        # the canonical forward (A-pose) gives T_t2a and the offsets
        out_a = smplx_forward(params, body_pose=canonical_body_pose)
        self.a_verts = out_a.vertices
        self.T_t2a = out_a.vertex_transforms  # [V, 4, 4]
        self.inv_T_t2a = torch.linalg.inv(out_a.vertex_transforms)
        self.canonical_offsets = out_a.shape_offsets + out_a.pose_offsets

    def point_transforms(self, body_pose, points, K: int = 6,
                         global_orient=None, betas=None, expression=None):
        """[N, 4, 4] canonical -> posed transforms for gaussian centres."""
        T_a2pose = a2pose_transforms(
            self.params, self.inv_T_t2a, self.canonical_offsets,
            body_pose=body_pose, global_orient=global_orient, betas=betas,
            expression=expression)
        return lbs_diffuse_transforms(self.params.lbs_weights, T_a2pose,
                                      points, self.a_verts, K=K)

    def deform_gaussians(self, gaussians, body_pose, K: int = 6, **kw):
        """(xyz', rotation') for every row of the state, each rigid under
        its blended transform."""
        T = self.point_transforms(body_pose, gaussians.xyz, K=K, **kw)
        return deform_points(T, gaussians.xyz, gaussians.rotation)
