"""SMPL-X body model in PyTorch (port of gaussianip_tpu/human/smplx_jax.py).

Standard SMPL-X linear blend skinning:
  v_shaped = v_template + shapedirs @ betas + exprdirs @ expression
  J        = J_regressor @ v_shaped
  pose blend shapes from (R_local - I) of the 54 non-root joints
  rigid chain along parents -> world joint transforms A
  per-vertex transform T = lbs_weights @ A
  verts    = (T @ [v_shaped + pose_offsets, 1])[:3]
plus the vertex-picked keypoints (nose/eyes/ears/feet/finger tips) appended
after the 55 skeleton joints in the smplx package order.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

# standard smplx vertex ids (smplx package vertex_ids.py, 'smplx' entry)
SMPLX_VERTEX_IDS = {
    "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
    "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
    "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
    "lring": 5169, "lpinky": 5286, "LBigToe": 5770, "LSmallToe": 5780,
    "LHeel": 8846, "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
}
# VertexJointSelector order: face, feet, hand tips (smplx package order)
EXTRA_JOINT_NAMES = (
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
)

NUM_JOINTS = 55  # 1 root + 21 body + jaw + 2 eyes + 2x15 hands
NUM_BODY_JOINTS = 21


class SMPLXParams(NamedTuple):
    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, n_betas]
    exprdirs: torch.Tensor  # [V, 3, n_expr]
    posedirs: torch.Tensor  # [54*9, V*3]
    j_regressor: torch.Tensor  # [55, V]
    parents: np.ndarray  # [55] host ints
    lbs_weights: torch.Tensor  # [V, 55]
    faces: np.ndarray  # [F, 3] host ints
    extra_joint_vids: np.ndarray  # [21] host ints


class SMPLXOutput(NamedTuple):
    vertices: torch.Tensor  # [V, 3]
    joints: torch.Tensor  # [55 + 21, 3]
    joint_transforms: torch.Tensor  # [55, 4, 4] world transforms A
    vertex_transforms: torch.Tensor  # [V, 4, 4] per-vertex T
    shape_offsets: torch.Tensor  # [V, 3]
    pose_offsets: torch.Tensor  # [V, 3]
    v_shaped: torch.Tensor  # [V, 3]


def _params(arrays: dict, parents, faces, vids, device) -> SMPLXParams:
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in arrays.items()}
    return SMPLXParams(parents=np.asarray(parents, np.int64),
                       faces=np.asarray(faces, np.int64),
                       extra_joint_vids=np.asarray(vids, np.int64), **t)


def load_smplx_npz(path: str, gender: str = "neutral", num_betas: int = 10,
                   num_expr: int = 10, device="cuda") -> SMPLXParams:
    """Load an official SMPL-X npz (<path>/SMPLX_<GENDER>.npz or a file)."""
    if os.path.isdir(path):
        path = os.path.join(path, f"SMPLX_{gender.upper()}.npz")
    data = np.load(path, allow_pickle=True)
    shapedirs_all = np.asarray(data["shapedirs"], np.float32)  # [V,3,400]
    # smplx layout: first 300 shape, last 100 expression
    shape_d = shapedirs_all[..., :num_betas]
    if shapedirs_all.shape[-1] >= 300 + num_expr:
        expr_d = shapedirs_all[..., 300:300 + num_expr]
    else:
        expr_d = np.zeros_like(shape_d[..., :num_expr])
    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 3:  # [V, 3, 54*9] -> [54*9, V*3]
        posedirs = posedirs.reshape(posedirs.shape[0] * 3, -1).T
    nj = NUM_JOINTS
    return _params(
        dict(v_template=data["v_template"], shapedirs=shape_d,
             exprdirs=expr_d, posedirs=posedirs[:(nj - 1) * 9],
             j_regressor=np.asarray(data["J_regressor"])[:nj],
             lbs_weights=np.asarray(data["weights"])[:, :nj]),
        np.asarray(data["kintree_table"], np.int64)[0][:nj], data["f"],
        [SMPLX_VERTEX_IDS[n] for n in EXTRA_JOINT_NAMES], device)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    small = angle < 1e-8
    axis = aa / torch.where(small, torch.ones_like(angle), angle)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + s * K + (1 - c) * (K @ K)
    return torch.where(small[..., None], eye, R)


def smplx_forward(
    params: SMPLXParams,
    betas: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,
    body_pose: Optional[torch.Tensor] = None,  # [21, 3] axis-angle
    global_orient: Optional[torch.Tensor] = None,  # [3]
    jaw_pose: Optional[torch.Tensor] = None,  # [3]
    left_hand_pose: Optional[torch.Tensor] = None,  # [15, 3]
    right_hand_pose: Optional[torch.Tensor] = None,  # [15, 3]
    transl: Optional[torch.Tensor] = None,  # [3]
) -> SMPLXOutput:
    """Single-sample SMPL-X forward. Zero hand pose == flat hands."""
    dev = params.v_template.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    V = params.v_template.shape[0]
    betas = zeros(params.shapedirs.shape[-1]) if betas is None else betas
    expression = (zeros(params.exprdirs.shape[-1]) if expression is None
                  else expression)
    body_pose = zeros(NUM_BODY_JOINTS, 3) if body_pose is None else body_pose
    global_orient = zeros(3) if global_orient is None else global_orient
    jaw_pose = zeros(3) if jaw_pose is None else jaw_pose
    left_hand_pose = (zeros(15, 3) if left_hand_pose is None
                      else left_hand_pose)
    right_hand_pose = (zeros(15, 3) if right_hand_pose is None
                       else right_hand_pose)

    shape_offsets = (torch.einsum("vcb,b->vc", params.shapedirs, betas)
                     + torch.einsum("vcb,b->vc", params.exprdirs, expression))
    v_shaped = params.v_template + shape_offsets
    joints = params.j_regressor @ v_shaped  # [55, 3]

    full_pose = torch.cat([global_orient[None], body_pose, jaw_pose[None],
                           zeros(2, 3), left_hand_pose, right_hand_pose], 0)
    R = rodrigues(full_pose)  # [55, 3, 3]
    eye = torch.eye(3, device=dev)
    pose_feature = (R[1:] - eye).reshape(-1)  # [54*9]
    pose_offsets = (pose_feature @ params.posedirs).reshape(V, 3)

    # rigid chain over the static 55-joint kintree
    parents = params.parents
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[parents[1:]]
    bottom = torch.tensor([[0.0, 0, 0, 1]], device=dev)

    def make_t(Rj, tj):
        return torch.cat([torch.cat([Rj, tj[:, None]], 1), bottom], 0)

    transforms = [make_t(R[0], rel[0])]
    for j in range(1, NUM_JOINTS):
        transforms.append(transforms[parents[j]] @ make_t(R[j], rel[j]))
    A = torch.stack(transforms, 0)  # [55, 4, 4]

    # remove the rest-pose joint locations (relative skinning transforms)
    j_h = torch.cat([joints, zeros(NUM_JOINTS, 1)], 1)
    A_rel = A.clone()
    A_rel[:, :3, 3] = A[:, :3, 3] - torch.einsum("jab,jb->ja", A, j_h)[:, :3]

    T = torch.einsum("vj,jab->vab", params.lbs_weights, A_rel)  # [V, 4, 4]
    v_posed = v_shaped + pose_offsets
    v_h = torch.cat([v_posed, torch.ones((V, 1), device=dev)], 1)
    verts = torch.einsum("vab,vb->va", T, v_h)[:, :3]

    extra = verts[torch.as_tensor(params.extra_joint_vids, device=dev)]
    joints_posed = torch.einsum(
        "jab,jb->ja", A_rel,
        torch.cat([joints, torch.ones((NUM_JOINTS, 1), device=dev)], 1))[:, :3]
    all_joints = torch.cat([joints_posed, extra], 0)

    if transl is not None:
        verts = verts + transl
        all_joints = all_joints + transl

    return SMPLXOutput(verts, all_joints, A_rel, T, shape_offsets,
                       pose_offsets, v_shaped)


def make_test_model(rng: np.random.Generator, n_verts: int = 200,
                    n_faces: int = 64, device="cuda") -> SMPLXParams:
    """Synthetic mini-model with the exact SMPL-X structure (the real
    SMPLX_*.npz is a licensed download). Same numpy draws, in the same order,
    as the JAX package's make_test_model."""
    v = rng.normal(0, 0.3, (n_verts, 3)).astype(np.float32)
    parents = np.zeros(NUM_JOINTS, np.int64)
    parents[1:] = rng.integers(0, np.arange(1, NUM_JOINTS))
    jr = rng.uniform(0, 1, (NUM_JOINTS, n_verts)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    w = rng.uniform(0, 1, (n_verts, NUM_JOINTS)).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    vids = rng.integers(0, n_verts, len(EXTRA_JOINT_NAMES))
    shapedirs = rng.normal(0, 0.01, (n_verts, 3, 10)).astype(np.float32)
    exprdirs = rng.normal(0, 0.001, (n_verts, 3, 10)).astype(np.float32)
    posedirs = rng.normal(0, 0.001, (54 * 9, n_verts * 3)).astype(np.float32)
    faces = rng.integers(0, n_verts, (n_faces, 3))
    return _params(
        dict(v_template=v, shapedirs=shapedirs, exprdirs=exprdirs,
             posedirs=posedirs, j_regressor=jr, lbs_weights=w),
        parents, faces, vids, device)
