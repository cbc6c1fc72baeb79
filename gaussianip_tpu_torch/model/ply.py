"""Binary PLY I/O for Gaussian splats (port of gaussianip_tpu/model/ply.py):
the stage-1 -> stage-3 handoff and the final avatar.

Attribute layout (the reference 3DGS layout):
  x y z nx ny nz f_dc_0..2 f_rest_0..(3R-1) opacity scale_0..2 rot_0..3
all float32 little-endian, one 'vertex' element, with the header plyfile
writes. f_dc / f_rest are flattened channel-major ([N, R, 3] -> transpose
-> [N, 3R]). The bytes equal the JAX package's writer's for the same
state.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .gaussians import GaussianState, empty_state


def _header(n_vertex: int, n_rest_props: int) -> bytes:
    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(n_rest_props)]
    props += ["opacity"]
    props += [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]
    lines = ["ply", "format binary_little_endian 1.0",
             f"element vertex {n_vertex}"]
    lines += [f"property float {p}" for p in props]
    lines += ["end_header"]
    return ("\n".join(lines) + "\n").encode("ascii")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def save_ply(path, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """Write raw (pre-activation) splat attributes; inputs are [N, ...]
    numpy arrays or tensors with the GaussianState layouts."""
    xyz = _np(xyz)
    n = xyz.shape[0]
    f_dc = _np(f_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = _np(f_rest).transpose(0, 2, 1).reshape(n, -1)
    opacity = _np(opacity).reshape(n, 1)
    normals = np.zeros_like(xyz)
    data = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, _np(scaling), _np(rotation)],
        axis=1).astype("<f4")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(n, f_rest.shape[1]))
        f.write(np.ascontiguousarray(data).tobytes())


def _sorted_props(props, prefix: str):
    return sorted((p for p in props if p.startswith(prefix)),
                  key=lambda s: int(s.split("_")[-1]))


def load_ply(path) -> dict:
    """Read a binary little-endian 3DGS ply -> dict of float32 numpy arrays
    with the GaussianState layouts (f_rest / scale / rot properties sorted
    by index, channel-major reshape)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    n, fmt, props = None, None, []
    for line in raw[:end].decode("ascii").splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and n is not None:
            if t[1] not in ("float", "float32"):
                raise ValueError(f"unsupported property type {t[1]}")
            props.append(t[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported ply format {fmt}")
    arr = np.frombuffer(raw, dtype=np.dtype([(p, "<f4") for p in props]),
                        count=n, offset=end)
    col = lambda name: np.array(arr[name], np.float32)
    stack = lambda names: np.stack([col(p) for p in names], axis=1)
    rest = _sorted_props(props, "f_rest_")
    f_rest = (stack(rest).reshape(n, 3, -1) if rest
              else np.zeros((n, 3, 0), np.float32))  # [N, 3, R]
    return {
        "xyz": stack(["x", "y", "z"]),
        "f_dc": stack(["f_dc_0", "f_dc_1", "f_dc_2"])[:, None, :],
        "f_rest": f_rest.transpose(0, 2, 1),
        "opacity": col("opacity")[:, None],
        "scaling": stack(_sorted_props(props, "scale_")),
        "rotation": stack(_sorted_props(props, "rot_")),
    }


def state_to_ply(state: GaussianState, path):
    """Save the active rows of a GaussianState."""
    n = state.n_active
    save_ply(path, *(getattr(state, f)[:n] for f in (
        "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")))


def state_from_ply(path, capacity: int | None = None, max_sh_degree: int = 0,
                   device="cuda") -> GaussianState:
    """Load a .ply into a padded GaussianState on `device` (capacity
    defaults to the next multiple of 4096 >= N); the SH degree is the
    file's or `max_sh_degree`, whichever is larger, and is active."""
    d = load_ply(path)
    n = d["xyz"].shape[0]
    if capacity is None:
        capacity = max(4096, -(-n // 4096) * 4096)
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    n_rest = d["f_rest"].shape[1]
    deg = int(round((n_rest + 1) ** 0.5)) - 1
    if (deg + 1) ** 2 - 1 != n_rest:
        raise ValueError(f"bad f_rest count {n_rest}")
    state = empty_state(capacity, max(deg, max_sh_degree), device)
    for f, a in d.items():  # f_rest of a lower degree: the rest stays 0
        getattr(state, f)[:n, :a.shape[1]] = torch.as_tensor(a, device=device)
    return state.replace(n_active=n, active_sh_degree=state.max_sh_degree)
