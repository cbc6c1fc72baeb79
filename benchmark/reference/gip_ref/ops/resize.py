"""Frozen copy of gaussianip_tpu_torch/ops/resize.py, plain PyTorch.

Linear image resize matching jax.image.resize(..., "linear"): bilinear
with half-pixel centres, antialiased (a triangle filter widened by the
scale) when shrinking, plain bilinear when growing."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_resize(x, height: int, width: int) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, height, width] in float32; returned as is
    when the size already matches."""
    if tuple(x.shape[-2:]) == (height, width):
        return x
    return F.interpolate(x.float(), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)
