"""Zero-shot avatar animation (port of gaussianip_tpu/human/animation.py):
bind a trained .ply to the SMPL-X surface and re-pose it from motion
capture.

  * the .ply is loaded with the animation coordinate shim (xyz / scaling
    y <-> z, quaternion components [2, 3] swapped and w negated);
  * per frame, the SMPL-X forward with body_pose = motion[frame, 1:22] and
    flat hands; the recentre / rescale constants are cached from the FIRST
    frame, then x 1.1^10;
  * bind (first frame): each gaussian to its closest mesh triangle (signed
    distance, face, barycentric uvw: ops/triangle.py); gaussians whose
    reconstruction error exceeds 0.01 are culled;
  * re-pose (later frames): xyz = bary(v0, v1, v2; uvw) + dist * normal;
  * an orbit render about the active gaussians' mean (y-up, black
    background, radius 2.5, fovy 50, 1024^2), one degree a frame, written
    at 30 fps (utils/saving.py:save_video).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.cameras import camera_from_c2w
from ..model import ply as ply_io
from ..model.gaussians import PARAM_FIELDS, empty_state, pad_to_capacity
from ..ops.camera_math import look_at_c2w
from ..ops.triangle import signed_distance_to_mesh
from ..render.render import RenderConfig, render
from .smplx import SMPLXParams, smplx_forward

def load_animation_ply(path, capacity: Optional[int] = None, device="cuda"):
    """A trained avatar .ply as a GaussianState in animation coordinates;
    capacity defaults to the next multiple of 4096 (at least 4096)."""
    d = ply_io.load_ply(path)
    d["xyz"][:, [1, 2]] = d["xyz"][:, [2, 1]]
    d["scaling"][:, [1, 2]] = d["scaling"][:, [2, 1]]
    rots = d["rotation"]
    rots[:, [2, 3]] = rots[:, [3, 2]]
    rots[:, 0] *= -1

    n = d["xyz"].shape[0]
    if capacity is None:
        capacity = max(4096, -(-n // 4096) * 4096)
    deg = int(round((d["f_rest"].shape[1] + 1) ** 0.5)) - 1
    st = pad_to_capacity(empty_state(capacity, deg, device), d, n)
    return st.replace(active_sh_degree=deg)


def load_motion(motion_path=None, motion_poses=None) -> np.ndarray:
    """Body poses [T, 21, 3] float32 (joints 1..21) from an AMASS-style
    `poses` array, [T, 55, 3] or the flat [T, 165]."""
    if motion_poses is None:
        motion_poses = np.load(motion_path)["poses"]
    mp = np.asarray(motion_poses, np.float32)
    if mp.ndim == 2:
        if mp.shape[1] % 3:
            raise ValueError(f"bad pose dim {mp.shape}")
        mp = mp.reshape(mp.shape[0], -1, 3)
    return mp[:, 1:22]


class AvatarAnimator:
    def __init__(self, gaussians, smplx_params: SMPLXParams,
                 motion_path=None, motion_poses=None):
        """gaussians: GaussianState in animation coordinates, on the body
        model's device; motion: an AMASS npz with `poses` [T, 55, 3] or
        [T, 165], or the array itself."""
        self.gaussians = gaussians
        self.params = smplx_params
        self.motion = load_motion(motion_path, motion_poses)
        self.faces = torch.as_tensor(smplx_params.faces, dtype=torch.int64,
                                     device=gaussians.device)
        self.ori_center = None
        self.ori_scale = None
        self.mapping = None  # (dist, face, uvw) after bind

    @property
    def n_frames(self) -> int:
        return len(self.motion)

    def _mesh_at(self, frame: int) -> torch.Tensor:
        dev = self.params.v_template.device
        with torch.no_grad():
            out = smplx_forward(self.params, body_pose=torch.as_tensor(
                self.motion[frame], device=dev))
        verts = out.vertices.cpu().numpy()
        if self.ori_center is None:
            vmin, vmax = verts.min(0), verts.max(0)
            self.ori_center = (vmax + vmin) / 2
            self.ori_scale = 0.6 / np.max(vmax - vmin)
        verts = (verts - self.ori_center) * self.ori_scale
        verts = verts * (1.1 ** 10)  # scale(-10)
        return torch.as_tensor(np.asarray(verts, np.float32),
                               device=self.gaussians.device)

    def _surface_points(self, verts, dist, face, uvw):
        fa = self.faces[face]
        v0, v1, v2 = verts[fa[:, 0]], verts[fa[:, 1]], verts[fa[:, 2]]
        nrm = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
        nrm = nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-20)
        return (uvw[:, 0:1] * v0 + uvw[:, 1:2] * v1 + uvw[:, 2:3] * v2
                + dist[:, None] * nrm)

    @torch.no_grad()
    def bind(self, frame: int = 0, err_threshold: float = 0.01,
             face_block: int = 1024) -> int:
        """First-frame binding and error culling; returns the culled
        count. The kept rows move, in order, into a fresh state of the same
        capacity."""
        verts = self._mesh_at(frame)
        g = self.gaussians
        n = g.n_active
        pts = g.xyz[:n]
        dist, face, uvw = signed_distance_to_mesh(pts, verts, self.faces,
                                                  face_block=face_block)
        rec = self._surface_points(verts, dist, face, uvw)
        keep = torch.linalg.norm(rec - pts, dim=-1) <= err_threshold
        idx = torch.nonzero(keep)[:, 0]
        st = empty_state(g.capacity, g.max_sh_degree, g.device)
        st = pad_to_capacity(
            st, {f: getattr(g, f)[:n][idx] for f in PARAM_FIELDS}, idx.numel())
        self.gaussians = st.replace(active_sh_degree=g.active_sh_degree)
        self.mapping = (dist[idx], face[idx], uvw[idx])
        return n - idx.numel()

    @torch.no_grad()
    def repose(self, frame: int):
        """Move the bound gaussians onto the mesh of `frame`."""
        if self.mapping is None:
            raise RuntimeError("repose: bind() first")
        pts = self._surface_points(self._mesh_at(frame), *self.mapping)
        xyz = self.gaussians.xyz.clone()
        xyz[:pts.shape[0]] = pts
        self.gaussians = self.gaussians.replace(xyz=xyz)

    def orbit_camera(self, azimuth_deg: float, elevation_deg: float = 0.0,
                     radius: float = 2.5, fovy_deg: float = 50.0,
                     height: int = 1024, width: int = 1024):
        """The orbit camera (a batch of 1) about the mean of the active
        gaussians; the animation world is y-up (no blender swap)."""
        g = self.gaussians
        dev = g.device
        el = np.deg2rad(elevation_deg)
        az = np.deg2rad(azimuth_deg)
        center = g.xyz[:g.n_active].mean(0)
        eye = center + radius * torch.tensor(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)],
            dtype=torch.float32, device=dev)
        c2w = look_at_c2w(eye[None], center[None],
                          torch.tensor([[0.0, 1.0, 0.0]], device=dev))
        fovy = torch.full((1,), np.deg2rad(fovy_deg), dtype=torch.float32,
                          device=dev)
        return camera_from_c2w(c2w, fovy, height, width)

    @torch.no_grad()
    def render_frame(self, azimuth_deg: float, elevation_deg: float = 0.0,
                     radius: float = 2.5, fovy_deg: float = 50.0,
                     height: int = 1024, width: int = 1024,
                     render_cfg: Optional[RenderConfig] = None):
        """One orbit frame [H, W, 3] in [0, 1] on a black background, on
        the state's device."""
        cams = self.orbit_camera(azimuth_deg, elevation_deg, radius,
                                 fovy_deg, height, width)
        out = render(self.gaussians, cams,
                     torch.zeros(3, device=self.gaussians.device),
                     render_cfg or RenderConfig())
        return out.rgb[0].clamp(0, 1)

    def render_motion(self, save_path: str, play: bool = True,
                      rotate: bool = True, height: int = 1024,
                      width: int = 1024, fps: int = 30,
                      max_frames: Optional[int] = None,
                      render_cfg: Optional[RenderConfig] = None) -> np.ndarray:
        """Playback as a uint8 video [T, H, W, 3], written to `save_path`
        (an mp4, or the .npy stack beside it without a video writer):
        min(n_frames, 360) frames, capped by `max_frames`."""
        if self.mapping is None:
            self.bind(0)
        total = min(self.n_frames, 360)
        if max_frames:
            total = min(total, max_frames)
        frames = []
        for i in range(total):
            if play:
                self.repose(i % self.n_frames)
            az = float(i % 360) if rotate else 0.0
            img = self.render_frame(az, height=height, width=width,
                                    render_cfg=render_cfg)
            frames.append((img * 255).to(torch.uint8).cpu().numpy())
        video = np.stack(frames)
        from ..utils.saving import save_video

        save_video(save_path, video, fps=fps)
        return video
