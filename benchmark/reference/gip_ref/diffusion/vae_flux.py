"""FLUX.1-dev's VAE (vae/config.json), plain PyTorch: diffusion/vae.py's
AutoencoderKL at the SD VAE's widths with 16 latent channels, no
quant_conv or post_quant_conv (`quant_convs` false: use_quant_conv and
use_post_quant_conv in its config) and latents (z - shift_factor) *
scaling_factor. The encoder and the decoder are vae.py's; the tree is the
port's without the two quant convs."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from . import vae


@dataclass(frozen=True)
class VAEConfig(vae.VAEConfig):
    latent_channels: int = 16
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    quant_convs: bool = False


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if cfg.quant_convs:
            raise ValueError("FLUX's VAE has no quant convs")
        self.cfg = cfg
        self.encoder = vae.Encoder(cfg)
        self.decoder = vae.Decoder(cfg)

    def encode(self, images, eps=None):
        """images [B, 3, H, W] in [-1, 1] -> (z - shift) * scale, z the
        posterior's mean or, with `eps`, its sample."""
        return self.latents(self.encoder(images), eps)

    def latents(self, moments, eps=None):
        """The scaled latents of the posterior whose (mean, logvar) the
        encoder gave as `moments`."""
        mean, logvar = moments.chunk(2, dim=1)
        z = mean
        if eps is not None:
            logvar = torch.clamp(logvar, -30.0, 20.0)
            z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return (z - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, latents):
        return self.decoder(latents / self.cfg.scaling_factor
                            + self.cfg.shift_factor)
