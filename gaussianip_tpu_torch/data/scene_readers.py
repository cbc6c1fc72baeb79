"""Posed-image scene loaders: COLMAP (binary) and Blender-synthetic (port
of gaussianip_tpu/data/scene_readers.py).

Host-side numpy, as in the JAX package: c2w matrices in the splat
renderer's convention ([right, up, -lookat | eye] columns) plus an initial
point cloud where the scene has one. A Blender frame's size comes from its
PNG header (the standard library); other formats go through PIL, imported
only for them. Where the size cannot be read (a missing file included) it
is 800, as in the JAX package."""

from __future__ import annotations

import json
import os
import struct as pystruct
from typing import List, NamedTuple, Optional

import numpy as np

# parameters per COLMAP camera model id (SIMPLE_PINHOLE, PINHOLE,
# SIMPLE_RADIAL, RADIAL, OPENCV, OPENCV_FISHEYE, FULL_OPENCV, FOV,
# SIMPLE_RADIAL_FISHEYE, RADIAL_FISHEYE, THIN_PRISM_FISHEYE)
COLMAP_N_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4,
                   9: 5, 10: 12}
FALLBACK_SIZE = 800
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class SceneCamera(NamedTuple):
    c2w: np.ndarray  # [4, 4]
    fovy: float
    fovx: float
    image_path: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    cameras: List[SceneCamera]
    points: Optional[np.ndarray]  # [N, 3]
    colors: Optional[np.ndarray]  # [N, 3] in [0, 1]
    nerf_normalization_radius: float


def _qvec2rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read_colmap_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        n = pystruct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model, w, h = pystruct.unpack("<iiQQ", f.read(24))
            n_params = COLMAP_N_PARAMS[model]
            params = pystruct.unpack("<" + "d" * n_params,
                                     f.read(8 * n_params))
            cams[cid] = (model, w, h, params)
    return cams


def _read_colmap_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        n = pystruct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = pystruct.unpack("<i", f.read(4))[0]
            q = pystruct.unpack("<dddd", f.read(32))
            t = pystruct.unpack("<ddd", f.read(24))
            cam_id = pystruct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = pystruct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)  # the 2D points
            images[iid] = (np.array(q), np.array(t), cam_id, name.decode())
    return images


def _read_colmap_points_bin(path):
    with open(path, "rb") as f:
        n = pystruct.unpack("<Q", f.read(8))[0]
        pts = np.zeros((n, 3))
        cols = np.zeros((n, 3))
        for i in range(n):
            f.read(8)  # id
            pts[i] = pystruct.unpack("<ddd", f.read(24))
            cols[i] = pystruct.unpack("<BBB", f.read(3))
            f.read(8)  # reprojection error
            track_len = pystruct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
    return pts, cols / 255.0


def _radius(centers) -> float:
    centers = np.stack(centers)
    return float(np.linalg.norm(
        centers - centers.mean(0, keepdims=True), axis=1).max() * 1.1)


def load_colmap_scene(path: str, images_dir: str = "images") -> SceneInfo:
    """COLMAP workspace (sparse/0/{cameras,images,points3D}.bin)."""
    sparse = os.path.join(path, "sparse", "0")
    cams = _read_colmap_cameras_bin(os.path.join(sparse, "cameras.bin"))
    imgs = _read_colmap_images_bin(os.path.join(sparse, "images.bin"))
    pts_file = os.path.join(sparse, "points3D.bin")
    pts, cols = (None, None)
    if os.path.exists(pts_file):
        pts, cols = _read_colmap_points_bin(pts_file)

    out, centers = [], []
    for _, (q, t, cam_id, name) in sorted(imgs.items()):
        model, w, h, params = cams[cam_id]
        if model in (0, 1):  # SIMPLE_PINHOLE / PINHOLE
            fx = params[0]
            fy = params[0] if model == 0 else params[1]
        else:
            fx = fy = params[0]
        w2c = np.eye(4)
        w2c[:3, :3] = _qvec2rot(q)
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c)
        # COLMAP looks down +z with y down; the renderer's columns are
        # [right, up, -lookat]: flip the y and z axes
        c2w[:3, 1:3] *= -1
        centers.append(c2w[:3, 3])
        fovy = 2 * np.arctan(h / (2 * fy))
        fovx = 2 * np.arctan(w / (2 * fx))
        out.append(SceneCamera(c2w.astype(np.float32), float(fovy),
                               float(fovx),
                               os.path.join(path, images_dir, name),
                               int(w), int(h)))
    return SceneInfo(out, pts, cols, _radius(centers))


def image_size(path: str):
    """(width, height) of an image file: a PNG's from its IHDR chunk, any
    other format's through PIL; (800, 800) where neither can read it."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return FALLBACK_SIZE, FALLBACK_SIZE
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        return pystruct.unpack(">II", head[16:24])
    try:
        from PIL import Image

        with Image.open(path) as im:
            return im.size
    except Exception:  # noqa: BLE001  (the JAX package's 800 fallback)
        return FALLBACK_SIZE, FALLBACK_SIZE


def load_blender_scene(path: str, split: str = "train",
                       white_background: bool = False) -> SceneInfo:
    """NeRF-synthetic transforms_{split}.json scene."""
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])
    out, centers = [], []
    for fr in meta["frames"]:
        c2w = np.array(fr["transform_matrix"], np.float32)
        # Blender / NeRF: the camera looks down -z with y up (OpenGL);
        # flip y and z into the renderer's convention
        c2w[:3, 1:3] *= -1
        img = fr["file_path"]
        if not os.path.splitext(img)[1]:
            img = img + ".png"
        p = os.path.normpath(os.path.join(path, img))
        w, h = image_size(p)
        fovy = 2 * np.arctan(np.tan(fovx / 2) * h / w)
        centers.append(c2w[:3, 3])
        out.append(SceneCamera(c2w, float(fovy), fovx, p, int(w), int(h)))
    return SceneInfo(out, None, None, _radius(centers))


def load_scene(path: str, **kw) -> SceneInfo:
    if os.path.exists(os.path.join(path, "sparse")):
        return load_colmap_scene(path, **kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return load_blender_scene(path, **kw)
    raise FileNotFoundError(
        f"no COLMAP sparse/ or transforms_train.json in {path}")
