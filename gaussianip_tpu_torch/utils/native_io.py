"""ctypes bindings of the native async artifact writer (native/
artifact_writer.cpp, port of gaussianip_tpu/utils/native_io.py): PLY and
PNG encoding and file writes on a background thread, off the training
loop. The library is the repository's native/libgaussianip_io.so, built on
demand with `make -C native`; when it cannot be built or loaded every write
returns False and the caller writes with the Python writers
(utils/saving.py:save_image)."""

from __future__ import annotations

import atexit
import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load(build_if_missing: bool = True):
    """Returns the loaded library or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_repo_root(), "native", "libgaussianip_io.so")
    if not os.path.exists(so) and build_if_missing:
        try:
            subprocess.run(["make", "-C", os.path.dirname(so)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):  # no make, no zlib.h
            return None
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.aw_init.restype = ctypes.c_int
    lib.aw_init.argtypes = []
    for name in ("aw_write_ply", "aw_write_png", "aw_write_ppm"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64]
    for name in ("aw_flush", "aw_shutdown"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.aw_pending.restype = ctypes.c_int64
    lib.aw_pending.argtypes = []
    lib.aw_init()
    atexit.register(lib.aw_shutdown)
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def write_ply_async(path: str, rows: np.ndarray) -> bool:
    """rows: [N, 17 + 3*n_rest] float32 in the 3DGS attribute order
    (xyz, normals, f_dc, f_rest, opacity, scale, rot)."""
    lib = load()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return lib.aw_write_ply(path.encode(), rows.ctypes.data, rows.shape[0],
                            rows.shape[1]) == 0


def write_png_async(path: str, rgb: np.ndarray) -> bool:
    """rgb: [H, W, 3] uint8, or float in [0, 1]."""
    lib = load()
    if lib is None:
        return False
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    rgb = np.ascontiguousarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {rgb.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return lib.aw_write_png(path.encode(), rgb.ctypes.data, rgb.shape[0],
                            rgb.shape[1]) == 0


def flush():
    """Wait until every queued write is on disk."""
    lib = load(build_if_missing=False)
    if lib is not None:
        lib.aw_flush()


def pending() -> int:
    lib = load(build_if_missing=False)
    return 0 if lib is None else int(lib.aw_pending())
