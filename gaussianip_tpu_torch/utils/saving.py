"""Artifact saving: images, grids, image sequences -> video, JSON, and the
run directory with its manifest (port of gaussianip_tpu/utils/saving.py).

PNGs are written and read with zlib and struct from the standard library
(8-bit RGB, filter 0, as native/artifact_writer.cpp writes them), so no
imaging package is needed. Images are numpy arrays, float in [0, 1] or
uint8."""

from __future__ import annotations

import json
import os
import re
import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _to_uint8(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    return a


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {rgb.shape}")
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, x = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 1:  # Sub: a running sum per byte of the pixel
            x = np.cumsum(x.reshape(w, bpp), axis=0).reshape(-1)
        elif f == 2:  # Up
            x = x + prev
        elif f in (3, 4):  # Average, Paeth: sequential over pixels
            x = x.reshape(w, bpp)
            up = prev.reshape(w, bpp)
            left = np.zeros(bpp, np.int32)
            for i in range(w):
                if f == 3:
                    x[i] = (x[i] + (left + up[i]) // 2) & 255
                else:
                    ul = up[i - 1] if i else np.zeros(bpp, np.int32)
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[i], ul))
                    x[i] = (x[i] + pred) & 255
                left = x[i]
            x = x.reshape(-1)
        elif f != 0:
            raise ValueError(f"bad PNG filter {f}")
        prev = x & 255
        out[y] = prev
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8: 8-bit, not interlaced, gray, RGB, gray
    + alpha or RGBA (alpha dropped)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type "
                         f"{color}, interlace {interlace}")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    px = px.reshape(h, w, channels)
    return np.repeat(px[..., :1], 3, axis=2) if channels < 3 else px[..., :3]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_image(path: str, img):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(_to_uint8(img)))
    return path


def save_image_grid(path: str, imgs, cols: Optional[int] = None):
    imgs = [_to_uint8(i) for i in imgs]
    n = len(imgs)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    h, w = imgs[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = im
    return save_image(path, grid)


def save_video(path: str, frames, fps: int = 30):
    """A playable mp4 at `path`, through OpenCV's VideoWriter (mp4v), else
    imageio (ffmpeg); without either, the frames as a uint8 .npy stack at
    path + ".npy". Returns the path written."""
    video = np.stack([_to_uint8(f) for f in frames])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import cv2

        h, w = video.shape[1:3]
        wr = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not wr.isOpened():
            raise RuntimeError("VideoWriter failed to open")
        for f in video:
            wr.write(f[..., ::-1])  # RGB -> BGR
        wr.release()
        if os.path.getsize(path) > 0:
            return path
        raise RuntimeError("empty mp4")
    except Exception:  # no OpenCV, or it could not encode: next writer
        pass
    try:
        import imageio

        imageio.mimwrite(path, video, fps=fps)
        return path
    except Exception:  # no imageio or no ffmpeg: the .npy stack
        alt = path + ".npy"
        np.save(alt, video)
        return alt


def save_img_sequence_as_video(out_path: str, img_dir: str,
                               pattern: str = r"(\d+)\.png", fps: int = 30):
    """Numbered PNG frames from a directory -> video (save_video)."""
    rx = re.compile(pattern)
    entries = []
    for f in os.listdir(img_dir):
        m = rx.fullmatch(f)
        if m:
            entries.append((int(m.group(1)), f))
    entries.sort()
    frames = [read_png(os.path.join(img_dir, f)) for _, f in entries]
    return save_video(out_path, frames, fps)


def save_json(path: str, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)
    return path


class RunDirs:
    """Per-run directory layout: <log_path>/<run_id>/ with save/ and the
    run manifest run.json, which holds the stage progress."""

    def __init__(self, log_path: str, run_id: str):
        self.root = os.path.join(log_path, run_id)
        self.save = os.path.join(self.root, "save")
        os.makedirs(self.save, exist_ok=True)

    def path(self, *parts):
        p = os.path.join(self.root, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def manifest(self, **updates):
        """Read-modify-write the run manifest (stage progress lives here)."""
        mp = os.path.join(self.root, "run.json")
        data = {}
        if os.path.exists(mp):
            with open(mp) as f:
                data = json.load(f)
        data.update(updates)
        save_json(mp, data)
        return data

    def manifest_get(self, key, default=None):
        """Read one key from the run manifest (None/default if absent)."""
        mp = os.path.join(self.root, "run.json")
        if not os.path.exists(mp):
            return default
        with open(mp) as f:
            return json.load(f).get(key, default)

    def snapshot_code(self, repo_dir: Optional[str] = None):
        """Record the code state that produced this run: the git commit and
        a patch of uncommitted changes under <run>/code/, the names of
        untracked files, and code_commit / code_dirty in the manifest. A
        no-op outside a git checkout."""
        import subprocess

        repo = repo_dir or os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        out_dir = os.path.join(self.root, "code")

        def git(*args):
            return subprocess.run(
                ["git", "-C", repo, *args], capture_output=True, text=True,
                timeout=30)

        try:
            head = git("rev-parse", "HEAD")
            if head.returncode != 0:
                return None
            os.makedirs(out_dir, exist_ok=True)
            commit = head.stdout.strip()
            with open(os.path.join(out_dir, "COMMIT"), "w") as f:
                f.write(commit + "\n")
            diff = git("diff", "HEAD")
            if diff.stdout:
                with open(os.path.join(out_dir, "uncommitted.patch"),
                          "w") as f:
                    f.write(diff.stdout)
            untracked = git("ls-files", "--others", "--exclude-standard")
            ut_names = [u for u in untracked.stdout.splitlines() if u]
            if ut_names:
                with open(os.path.join(out_dir, "UNTRACKED"), "w") as f:
                    f.write("\n".join(ut_names) + "\n")
            dirty = bool(diff.stdout.strip()) or bool(ut_names)
            self.manifest(code_commit=commit, code_dirty=dirty)
            return commit
        except (OSError, subprocess.SubprocessError):  # no git
            return None
