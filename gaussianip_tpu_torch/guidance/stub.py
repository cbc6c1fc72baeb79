"""Stub guidance: a fake score-distillation signal for smoke runs without
the diffusion stack (port of gaussianip_tpu/guidance/stub.py).

    target = detach(rgb - grad)
    loss   = 0.5 * ||rgb - target||^2 / B
with `grad` = (rgb - target image) + noise_scale * noise and B the whole
batch's size (view_aux["batch_size"], else rgb's rows: a data-parallel
rank holds only its own rows). The noise is an argument: the train step
draws it from its generator with `sample_noise`.
"""

from __future__ import annotations

import torch

from ..ops.resize import linear_resize


class StubGuidance:
    def __init__(self, target_rgb=None, noise_scale: float = 0.1):
        self.target_rgb = target_rgb  # [H', W', 3] or None
        self.noise_scale = noise_scale

    def sample_noise(self, generator: torch.Generator, shape, device):
        return torch.randn(shape, generator=generator, device=device)

    def _target(self, h: int, w: int, device):
        tgt = torch.as_tensor(self.target_rgb, dtype=torch.float32,
                              device=device)
        return linear_resize(tgt.permute(2, 0, 1)[None], h, w).permute(
            0, 2, 3, 1)

    def __call__(self, step, noise, rgb, control_img, view_aux):
        b = view_aux.get("batch_size", rgb.shape[0])
        if self.target_rgb is not None:
            grad = rgb - self._target(rgb.shape[1], rgb.shape[2], rgb.device)
        else:
            grad = torch.zeros_like(rgb)
        grad = grad + self.noise_scale * noise
        target = (rgb - grad).detach()
        loss_sds = 0.5 * ((rgb - target) ** 2).sum() / b
        return {"loss_sds": loss_sds,
                "grad_norm": torch.linalg.norm(grad.detach())}


def make_stub_guidance(target_rgb=None, noise_scale: float = 0.1):
    """target_rgb: optional [H', W', 3] image the fake score pulls toward."""
    return StubGuidance(target_rgb, noise_scale)
