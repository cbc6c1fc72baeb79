"""Skeleton: SMPL-X-driven OpenPose keypoints and the body mesh for avatar
init (port of gaussianip_tpu/human/skeleton.py). A-pose SMPL-X forward,
SMPL-X joints -> OpenPose-18, rescale to 0.6 extent + recenter, OpenGL ->
Blender y/z swap, scale(-10), area-weighted surface sampling. Host-side
state is numpy."""

from __future__ import annotations

import math

import numpy as np
import torch

from .smplx import SMPLXParams, load_smplx_npz, smplx_forward

# SMPL-X joints (55 skeleton + extras) -> OpenPose-18, 0-based
OPENPOSE18_FROM_SMPLX = np.array(
    [55, 12, 17, 19, 21, 16, 18, 20, 2, 5, 8, 1, 4, 7, 56, 57, 58, 59],
    np.int64,
)
OPENPOSE18_NAMES = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear",
)
# limb segments
OPENPOSE18_LINES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8], [8, 9],
     [9, 10], [1, 11], [11, 12], [12, 13], [0, 14], [14, 16], [0, 15],
     [15, 17]],
    np.int64,
)
# controlnet_aux keypoint colors
OPENPOSE18_COLORS = np.array(
    [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
     [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
     [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
     [255, 0, 255], [255, 0, 170], [255, 0, 85]],
    np.float32,
)


def apose_body_pose() -> np.ndarray:
    """The reference's A-pose, [21, 3]."""
    bp = np.zeros((21, 3), np.float32)
    bp[0, 1] = 0.2
    bp[0, 2] = 0.1
    bp[1, 1] = -0.2
    bp[1, 2] = -0.1
    bp[15, 2] = -math.pi / 4
    bp[16, 2] = math.pi / 4
    bp[19, 0] = 1.0
    bp[20, 0] = 1.0
    return bp


class Skeleton:
    """Holds the SMPL-X params and the current (rescaled, y/z-swapped)
    vertices and keypoints as numpy arrays."""

    def __init__(self, smplx_path=None, gender="neutral", apose=True,
                 _test_model: SMPLXParams | None = None, device="cuda"):
        self.apose = apose
        if _test_model is not None:
            self.params = _test_model
        else:
            self.params = load_smplx_npz(smplx_path, gender, device=device)
        self.vertices = None  # [V, 3] numpy
        self.faces = np.asarray(self.params.faces)
        self.points3d = None  # [18, 3] numpy (blender coords)
        self.ori_center = None
        self.ori_scale = None

    def forward_smplx(self, betas=None, expression=None, body_pose=None):
        if body_pose is None:
            body_pose = np.zeros((21, 3), np.float32)
        if self.apose:
            ap = apose_body_pose()
            body_pose = np.where(ap != 0, ap, body_pose).astype(np.float32)
        dev = self.params.v_template.device
        as_t = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=dev)
        with torch.no_grad():
            out = smplx_forward(self.params, betas=as_t(betas),
                                expression=as_t(expression),
                                body_pose=as_t(body_pose))
        verts = out.vertices.cpu().numpy()
        joints = out.joints.cpu().numpy()[OPENPOSE18_FROM_SMPLX]

        # rescale to 0.6 max extent + recenter
        vmin, vmax = verts.min(0), verts.max(0)
        self.ori_center = (vmax + vmin) / 2
        self.ori_scale = 0.6 / np.max(vmax - vmin)
        verts = (verts - self.ori_center) * self.ori_scale
        joints = (joints - self.ori_center) * self.ori_scale

        # opengl -> blender (swap y/z)
        verts[:, [1, 2]] = verts[:, [2, 1]]
        joints[:, [1, 2]] = joints[:, [2, 1]]
        self.vertices = verts
        self.points3d = joints
        return out

    def scale(self, delta):
        """scale(-10) => x1.1^10 ~ 2.594."""
        f = 1.1 ** (-delta)
        self.points3d = self.points3d * f
        if self.vertices is not None:
            self.vertices = self.vertices * f

    @property
    def hand_centers(self):
        il = OPENPOSE18_NAMES.index("left_wrist")
        ir = OPENPOSE18_NAMES.index("right_wrist")
        return self.points3d[[il, ir]]

    def sample_smplx_points(self, N=20000, seed=0):
        """Area-weighted surface sampling (numpy rng, as the JAX package)."""
        assert self.vertices is not None, "call forward_smplx first"
        return sample_surface_points(self.vertices, self.faces, N, seed)


def sample_surface_points(v, f, N: int, seed: int) -> np.ndarray:
    """N area-weighted points on the mesh (v [V, 3], f [F, 3]), float32."""
    rng = np.random.default_rng(seed)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    p = area / area.sum()
    fi = rng.choice(len(f), size=N, p=p)
    r1 = np.sqrt(rng.uniform(size=(N, 1)))
    r2 = rng.uniform(size=(N, 1))
    a = 1 - r1
    b = r1 * (1 - r2)
    c = r1 * r2
    pts = a * v[f[fi, 0]] + b * v[f[fi, 1]] + c * v[f[fi, 2]]
    return pts.astype(np.float32)
