"""Frozen copy of gaussianip_tpu_torch/diffusion/layers.py, plain PyTorch.

The flax layers the diffusion modules are built from, as torch modules
with float32 parameters computed at a `dtype` (flax's `dtype` with
`param_dtype` float32): Dense (nn.Dense), Conv (nn.Conv with an explicit
padding) and LayerNorm (float32 statistics).

Parameter names follow torch (`weight`, `bias`); `diffusion/from_flax.py`
maps flax's `kernel` / `scale` onto them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lowp import quant


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x):
        dt = self.dtype
        return F.linear(quant(x.to(dt)), quant(self.weight.to(dt)),
                        None if self.bias is None else self.bias.to(dt))


class Conv(nn.Module):
    """k x k conv; `padding` is an int or ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding=0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        (pt, pb), (pl, pr) = padding
        self.sym = pt if (pt == pb == pl == pr) else None
        self.pad = (pl, pr, pt, pb)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.sym is None:
            x = F.pad(x, self.pad)
        return F.conv2d(quant(x), quant(self.weight.to(dt)),
                        self.bias.to(dt),
                        stride=self.stride, padding=self.sym or 0)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)
