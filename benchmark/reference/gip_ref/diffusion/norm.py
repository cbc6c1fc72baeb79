"""Frozen copy of gaussianip_tpu_torch/diffusion/norm.py, plain PyTorch.

GroupNorm with float32 statistics (port of
gaussianip_tpu/diffusion/norm.py).

The JAX package's custom VJP there is a layout trick for XLA on the TPU,
not a Pallas kernel; here autograd differentiates the same formula.
Statistics are sum(x) and sum(x^2) per (batch, group) in float32, as the
JAX fast path computes them; the output has the input's dtype. Channels
group consecutively (group = c // (C / G)). The reshapes run on the
channels-last view, so a channels_last input stays one.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def group_norm(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """x [B, C, ...]; weight, bias [C]. y = (x - mean_g) * rsqrt(var_g +
    eps) * weight + bias, statistics over (spatial, channels in group)."""
    b, c = x.shape[:2]
    xh = x.float().movedim(1, -1)  # [B, ..., C]
    g = xh.reshape(b, -1, groups, c // groups)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = (g * g).mean(dim=(1, 3), keepdim=True) - mu * mu
    inv = torch.rsqrt(var.clamp(min=0.0) + eps)
    y = ((g - mu) * inv).reshape(xh.shape) * weight.float() + bias.float()
    return y.to(x.dtype).movedim(-1, 1)


class GroupNorm(nn.Module):
    """FastGroupNorm: float32 `weight` (flax `scale`) and `bias` [C]."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps)
