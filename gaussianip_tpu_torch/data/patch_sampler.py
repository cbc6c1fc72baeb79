"""Mask-guided random patch crops (port of
gaussianip_tpu/data/patch_sampler.py): patch centres drawn on foreground
pixels, used by the experimental avatar losses."""

from __future__ import annotations

import torch


def crop_patches(image: torch.Tensor, corners: torch.Tensor,
                 patch_size: int) -> torch.Tensor:
    """[N, P, P, C] crops of image [H, W, C] at top-left corners [N, 2]
    (y, x), each inside the image."""
    r = torch.arange(patch_size, device=image.device)
    ys = corners[:, 0, None] + r  # [N, P]
    xs = corners[:, 1, None] + r
    return image[ys[:, :, None], xs[:, None, :]]


def sample_patches(generator: torch.Generator, image: torch.Tensor,
                   mask: torch.Tensor, patch_size: int, num_patches: int):
    """Crop `num_patches` patches of `patch_size` whose centres land on
    foreground (mask > 0.5) pixels when there are any, else anywhere;
    centres are drawn with replacement from `generator`, then clipped to
    [half, size - patch + half]. image: [H, W, C]; mask: [H, W]. Returns
    patches [N, P, P, C] and the top-left corners [N, 2] (y, x)."""
    h, w = mask.shape
    half = patch_size // 2
    fg = (mask.reshape(-1) > 0.5).to(torch.float32)
    probs = fg if bool(fg.sum() > 0) else torch.ones_like(fg)
    idx = torch.multinomial(probs, num_patches, replacement=True,
                            generator=generator)
    cy = torch.clamp(idx // w, half, h - patch_size + half)
    cx = torch.clamp(idx % w, half, w - patch_size + half)
    corners = torch.stack([cy - half, cx - half], -1)
    return crop_patches(image, corners, patch_size), corners
