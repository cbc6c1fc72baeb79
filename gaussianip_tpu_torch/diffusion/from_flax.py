"""Carry a flax parameter tree into a port module.

The port's diffusion modules name their submodules exactly as the flax
modules do (`down_0_res_0.conv1`, `to_q.main`, `zero_conv_3`, ...), so the
carry-over is a tree walk: a Dense `kernel` [in, out] becomes `weight`
[out, in], a conv `kernel` HWIO becomes `weight` OIHW, a norm `scale`
becomes `weight`, and every other leaf keeps its name and shape.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn


def torch_key(path, ndim: int):
    """A flax leaf's path (module names, then the leaf name) and rank ->
    (the port's dotted parameter name, the axis order that turns the flax
    array into the port's, or None to keep it)."""
    *mods, leaf = path
    perm = None
    if leaf == "kernel":
        leaf, perm = "weight", ((1, 0) if ndim == 2 else (3, 2, 0, 1))
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*mods, leaf]), perm


def flax_state_dict(params) -> dict[str, torch.Tensor]:
    """A flax param tree (nested mappings of arrays, with or without the
    top-level "params" collection) as a torch state dict of float32 CPU
    tensors."""
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            name, perm = torch_key(path + (k,), a.ndim)
            if perm is not None:
                a = a.transpose(perm)
            out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, ())
    return out


def from_flax(module: nn.Module, params) -> nn.Module:
    """Load a flax param tree into `module` in place (strict: every
    parameter of the module and every leaf of the tree must meet); the
    parameters keep their device and dtype. Returns the module."""
    module.load_state_dict(flax_state_dict(params), strict=True)
    return module
