"""Frozen copy of gaussianip_tpu_torch/ops/conv3x3.py, plain PyTorch: the
3x3 conv of the UNet / ControlNet as F.conv2d (in place of K3), with the
same float32 parameters computed at `dtype`."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lowp import quant


def conv3x3(x, weight, bias=None, stride: int = 1) -> torch.Tensor:
    """3x3 NCHW / OIHW conv with padding 1, computed in x's dtype."""
    return F.conv2d(quant(x), quant(weight.to(x.dtype)),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=1)


class Conv3x3(nn.Module):
    """The Conv3x3 module: float32 `weight` [Co, Ci, 3, 3] and `bias` [Co],
    computed at `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return conv3x3(x.to(self.dtype), self.weight, self.bias,
                       stride=self.stride)
