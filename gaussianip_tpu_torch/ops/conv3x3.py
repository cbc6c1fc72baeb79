"""3x3 convolution of the UNet / ControlNet (port of
gaussianip_tpu/ops/conv_pallas.py: conv3x3 and Conv3x3).

Stride 1 runs K3 (ops/conv3x3_cuda.py) behind a torch.autograd.Function,
on every call on the card: the TPU gate of the JAX package (128-aligned
channels, h*w >= 4096, 8 | w: Mosaic lane rules) is not ported. The
backward mirrors the JAX custom VJP: dx is K3 itself on the weight rotated
180 degrees with its channels swapped, dW is the library's filter gradient
(torch.nn.grad.conv2d_weight, as the JAX package leaves it to XLA), dbias a
sum. Stride 2 (Downsample) is F.conv2d, as the JAX kernel never handles it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv3x3_cuda import conv3x3_same


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv3x3_same(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # [Ci, Co, 3, 3]: the transposed conv as a 3x3 conv of g
            dx = conv3x3_same(g, weight.flip(2, 3).transpose(0, 1))
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x, weight.shape, g, padding=1).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 2, 3))
        return dx, dw, db


def conv3x3(x, weight, bias=None, stride: int = 1) -> torch.Tensor:
    """3x3 NCHW / OIHW conv with padding 1, computed in x's dtype (the
    weight is cast to it). Gradients reach x, weight and bias."""
    if stride == 1:
        return _Conv3x3Same.apply(x, weight, bias)
    return F.conv2d(x, weight.to(x.dtype),
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
