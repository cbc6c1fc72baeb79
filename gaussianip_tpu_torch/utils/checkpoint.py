"""Stage-1 train-state checkpoints in the JAX package's .npz layout (port of
save_train_state_npz / load_train_state_npz of
gaussianip_tpu/utils/checkpoint.py), so that either package resumes from
the other's file.

The file holds `n` and `leaf_0` ... `leaf_{n-1}`, the leaves in the order
of jax.tree_util.tree_flatten(TrainState): the GaussianState data fields
(n_active as an int32 scalar; the SH degrees are static there and are not
stored), the Adam moments m and v with their keys sorted, the Adam count,
the densify statistics, and the step as int32. LEAF_ORDER pins it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..model.adam import AdamState
from ..model.densify import DensifyStats
from ..model.gaussians import PARAM_FIELDS
from ..system.stage1 import TrainState

_GAUSSIAN_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation",
                    "opacity")
_STATS_FIELDS = ("xyz_grad_accum", "denom", "max_radii2d")
LEAF_ORDER = (
    tuple(f"gaussians.{f}" for f in _GAUSSIAN_FIELDS)
    + ("gaussians.n_active",)
    + tuple(f"opt.{mv}.{f}" for mv in ("m", "v") for f in sorted(PARAM_FIELDS))
    + ("opt.count",)
    + tuple(f"stats.{f}" for f in _STATS_FIELDS)
    + ("step",)
)
_INT_LEAVES = ("gaussians.n_active", "opt.count", "step")


def _get(ts: TrainState, name: str):
    parts = name.split(".")
    if parts[0] == "opt" and parts[1] in ("m", "v"):
        return getattr(ts.opt, parts[1])[parts[2]]
    obj = ts
    for p in parts:
        obj = getattr(obj, p)
    return obj


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_train_state_npz(path: str, ts: TrainState) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    leaves = {}
    for i, name in enumerate(LEAF_ORDER):
        v = _get(ts, name)
        leaves[f"leaf_{i}"] = (np.asarray(int(v), np.int32)
                               if name in _INT_LEAVES else _host(v))
    np.savez(path, n=len(LEAF_ORDER), **leaves)
    return path


def load_train_state_npz(path: str, like: TrainState) -> TrainState:
    """The checkpoint at `path` on `like`'s device, with `like`'s static SH
    degrees; every array must have `like`'s shape (the same capacity)."""
    dev = like.gaussians.device
    with np.load(path) as data:
        if int(data["n"]) != len(LEAF_ORDER):
            raise ValueError(f"{path}: {int(data['n'])} leaves, the train "
                             f"state has {len(LEAF_ORDER)}")
        d = {name: data[f"leaf_{i}"] for i, name in enumerate(LEAF_ORDER)}
    t = {}
    for name, a in d.items():
        if name in _INT_LEAVES:
            t[name] = int(a)
            continue
        want = tuple(_get(like, name).shape)
        if a.shape != want:
            raise ValueError(f"{path}: {name} has shape {a.shape}, the "
                             f"train state {want}")
        t[name] = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    g = like.gaussians.replace(
        **{f: t[f"gaussians.{f}"] for f in _GAUSSIAN_FIELDS},
        n_active=t["gaussians.n_active"])
    opt = AdamState(m={f: t[f"opt.m.{f}"] for f in PARAM_FIELDS},
                    v={f: t[f"opt.v.{f}"] for f in PARAM_FIELDS},
                    count=t["opt.count"])
    stats = DensifyStats(**{f: t[f"stats.{f}"] for f in _STATS_FIELDS})
    return TrainState(g, opt, stats, t["step"])
