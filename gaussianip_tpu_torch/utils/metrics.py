"""Image quality metrics on tensors: PSNR, SSIM and L1 (port of
gaussianip_tpu/utils/metrics.py). SSIM: the 11x11 Gaussian window (sigma
1.5), SAME zero padding, per channel, C1 = 0.01^2, C2 = 0.03^2. LPIPS is
diffusion/lpips.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img, ref):
    """[..., H, W, C] -> scalar PSNR in dB (images in [0, 1])."""
    mse = torch.mean((img - ref) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(img, ref, window_size: int = 11):
    """Mean SSIM over [B, H, W, C] (or [H, W, C]) images in [0, 1]."""
    if img.dim() == 3:
        img, ref = img[None], ref[None]
    c = img.shape[-1]
    w = _gaussian_window(window_size, device=img.device).to(img.dtype)
    kernel = w.expand(c, 1, window_size, window_size)
    x, y = img.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2)

    def filt(a):
        return F.conv2d(a, kernel, padding=window_size // 2, groups=c)

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


def l1(img, ref):
    return torch.mean(torch.abs(img - ref))
