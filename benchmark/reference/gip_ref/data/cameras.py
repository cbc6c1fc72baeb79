"""Frozen copy of gaussianip_tpu_torch/data/cameras.py, plain PyTorch.

Batched camera for the splat renderer (port of
gaussianip_tpu/data/cameras.py; the JAX vmap over cameras becomes the
leading dim of every tensor here)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.camera_math import camera_matrices


@dataclass
class Camera:
    world_view_t: torch.Tensor  # [B, 4, 4] transposed w2c (p_row @ M)
    full_proj_t: torch.Tensor  # [B, 4, 4] transposed view-proj
    camera_center: torch.Tensor  # [B, 3]
    fovx: torch.Tensor  # [B] radians
    fovy: torch.Tensor  # [B] radians
    height: int = 512
    width: int = 512

    @property
    def batch(self) -> int:
        return self.world_view_t.shape[0]

    @property
    def tan_fovx(self):
        return torch.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self):
        return torch.tan(self.fovy * 0.5)


def camera_from_c2w(c2w, fovy, height: int, width: int, znear=0.01,
                    zfar=100.0) -> Camera:
    """[B] cameras from c2w [B, 4, 4] and vertical FoV [B] (radians)."""
    c2w = c2w.to(torch.float32)
    fovy = fovy.to(torch.float32)
    world_view_t, full_proj_t, center, fovx = camera_matrices(
        c2w, fovy, height, width, znear, zfar)
    return Camera(world_view_t, full_proj_t, center, fovx, fovy, height,
                  width)
