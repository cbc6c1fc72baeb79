"""Frozen copy of gaussianip_tpu_torch/diffusion/lpips.py, plain PyTorch.

LPIPS perceptual distance on a VGG16 backbone (port of
gaussianip_tpu/diffusion/lpips.py), stage 3's perceptual loss.

The published LPIPS design: VGG16 features after the last relu of each
stage (relu1_2 ... relu5_3), unit-normalised over channels, squared
difference, 1x1 linear heads with non-negative weights (|w|), spatial
mean, summed over stages. Inputs are [B, H, W, 3] as the JAX package takes
them; the VGG runs NCHW in channels_last memory. Its convs are nn.Conv in
the JAX package, outside any Pallas kernel, so they stay F.conv2d here.
Max-pooling floors odd sizes, as flax's VALID max_pool.

Submodules carry the flax names (`vgg.conv_{i}`, `lin_{i}`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv

# (channels, convs) per stage; features are tapped after each stage
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision's ImageNet normalisation, as LPIPS folds it in
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# torchvision vgg16 `features.{i}` index of each conv
VGG16_CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGG16Features(nn.Module):
    """VGG16's conv trunk; `stages` overrides the plan (tests use a narrow
    one). Returns the feature map after each stage."""

    def __init__(self, stages=VGG16_STAGES, dtype=torch.float32):
        super().__init__()
        self.stages = tuple(stages)
        prev, ci = 3, 0
        for ch, n in self.stages:
            for _ in range(n):
                self.add_module(f"conv_{ci}", Conv(prev, ch, 3, padding=1,
                                                   dtype=dtype))
                prev, ci = ch, ci + 1

    def forward(self, x):
        feats, ci = [], 0
        for si, (_, n) in enumerate(self.stages):
            for _ in range(n):
                x = F.relu(getattr(self, f"conv_{ci}")(x))
                ci += 1
            feats.append(x)
            if si < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self, stages=VGG16_STAGES, dtype=torch.float32):
        super().__init__()
        self.vgg = VGG16Features(stages, dtype)
        for i, (ch, _) in enumerate(stages):
            self.register_parameter(f"lin_{i}", nn.Parameter(torch.ones(ch)))

    def forward(self, x, y, normalize: bool = True):
        """x, y [B, H, W, 3] (in [0, 1] with `normalize`, else [-1, 1])
        -> [B] float32 distances. Both run through the VGG as one batch."""
        b = x.shape[0]
        xy = torch.cat([x, y]).float()
        if normalize:
            xy = 2.0 * xy - 1.0
        const = lambda v: torch.tensor(v, device=xy.device)
        xy = ((xy - const(LPIPS_SHIFT)) / const(LPIPS_SCALE)).permute(
            0, 3, 1, 2)
        total = 0.0
        for i, f in enumerate(self.vgg(xy.contiguous(
                memory_format=torch.channels_last))):
            f = f.float()
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True)
                     + 1e-10)
            d = (f[:b] - f[b:]) ** 2
            w = getattr(self, f"lin_{i}").abs()
            total = total + (d * w[:, None, None]).sum(1).mean(dim=(1, 2))
        return total
