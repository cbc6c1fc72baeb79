"""Frozen copy of gaussianip_tpu_torch/model/gaussians.py, plain PyTorch.

GaussianState: the 3D Gaussian-splat avatar at fixed padded capacity (port
of gaussianip_tpu/model/gaussians.py).

Field layouts (reference .ply compatible):
  xyz       [CAP, 3]      world positions
  f_dc      [CAP, 1, 3]   SH DC coeffs
  f_rest    [CAP, R, 3]   SH rest coeffs (R = (deg+1)^2 - 1)
  scaling   [CAP, 3]      log-scale      (activation: exp)
  rotation  [CAP, 4]      raw quaternion wxyz (activation: L2 normalize)
  opacity   [CAP, 1]      logit          (activation: sigmoid)
Rows at and beyond `n_active` (a host int) are padding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops.sh import rgb_to_sh
from ..ops.transforms import inverse_sigmoid

PAD_XYZ = 1e8  # padding slots parked far outside every frustum
PAD_OPACITY = -30.0  # sigmoid(-30) ~ 1e-13, far below the 1/255 alpha cutoff
PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@dataclass
class GaussianState:
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    n_active: int
    max_sh_degree: int = 0
    active_sh_degree: int = 0

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_active

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_features(self):
        """[CAP, (deg+1)^2, 3] — dc then rest, coeff-major."""
        return torch.cat([self.f_dc, self.f_rest], dim=1)


def fresh_param_buffers(capacity: int, n_rest: int, device) -> dict:
    """Padding values for every parameter field."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "xyz": torch.full((capacity, 3), PAD_XYZ, **f32),
        "f_dc": torch.zeros((capacity, 1, 3), **f32),
        "f_rest": torch.zeros((capacity, n_rest, 3), **f32),
        "opacity": torch.full((capacity, 1), PAD_OPACITY, **f32),
        "scaling": torch.full((capacity, 3), -10.0, **f32),
        "rotation": torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(capacity, 1),
    }


def empty_state(capacity: int, max_sh_degree: int = 0,
                device="cuda") -> GaussianState:
    n_rest = (max_sh_degree + 1) ** 2 - 1
    return GaussianState(**fresh_param_buffers(capacity, n_rest, device),
                         n_active=0, max_sh_degree=max_sh_degree,
                         active_sh_degree=0)


def create_from_pcd(points, colors, capacity: int, mean_dist2,
                    max_sh_degree: int = 0, device="cuda") -> GaussianState:
    """Initialize from a point cloud: isotropic scale log(sqrt(mean 3-NN
    squared distance)), identity rotation, opacity logit(0.1), colors -> SH
    DC."""
    f32 = dict(dtype=torch.float32, device=device)
    points = torch.as_tensor(points, **f32)
    colors = torch.as_tensor(colors, **f32)
    n = points.shape[0]
    assert n <= capacity, f"{n} points exceed capacity {capacity}"
    dist2 = torch.clamp(torch.as_tensor(mean_dist2, **f32), min=1e-7)
    state = empty_state(capacity, max_sh_degree, device)
    state.xyz[:n] = points
    state.f_dc[:n] = rgb_to_sh(colors)[:, None, :]
    state.scaling[:n] = torch.log(torch.sqrt(dist2))[:, None]
    state.opacity[:n] = inverse_sigmoid(torch.full((n, 1), 0.1, **f32))
    state.n_active = n
    return state
