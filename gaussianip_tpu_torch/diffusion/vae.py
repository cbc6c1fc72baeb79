"""AutoencoderKL, the SD VAE (port of gaussianip_tpu/diffusion/vae.py),
NCHW in channels_last memory.

Its convs are nn.Conv in the JAX package, not Conv3x3, so they stay
F.conv2d here. GroupNorm epsilon is 1e-6 throughout; the encoder's
stride-2 downsample pads ((0, 1), (0, 1)). `encode` takes the posterior
noise as an argument.

Every GroupNorm here is a `VAEGroupNorm`: the fused kernel K4
(ops/groupnorm_cuda.py) on the card, with the SiLU that follows it fused
in (the resnets' norm1 / norm2 and conv_norm_out) or not (the mid
attention's group_norm). The VAE's tensors are large (4 x 128 x 512^2 in
the stage-1 encode) and its GroupNorms are bound by bytes, which K4 cuts
to two passes each way. The modules keep norm.GroupNorm's parameters and
names.

The mid blocks' single-head attention (one 512-wide head) runs K5
(ops/vae_attention_cuda.py), not SDPA: no fused SDPA backend takes a head
that wide at the tensor cores' rate. The UNet's attention keeps
`blocks.attend`.

FLUX.1-dev's VAE has the same widths with 16 latent channels, no quant
convs (`quant_convs` false: its config's use_quant_conv and
use_post_quant_conv) and latents (z - shift_factor) * scaling_factor
(FLUX_VAE_SCALING, FLUX_VAE_SHIFT).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Dense
from ..ops.groupnorm_cuda import group_norm_silu
from ..ops.vae_attention_cuda import vae_attention
from .norm import GroupNorm

SD_VAE_SCALING = 0.18215
SDXL_VAE_SCALING = 0.13025  # the same widths, SDXL's latent scale
FLUX_VAE_SCALING = 0.3611  # FLUX.1-dev's vae/config.json
FLUX_VAE_SHIFT = 0.1159


@dataclass(frozen=True)
class VAEConfig:
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = SD_VAE_SCALING
    shift_factor: float = 0.0
    quant_convs: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def downscale(self) -> int:
        """Image side over latent side."""
        return 2 ** (len(self.block_out_channels) - 1)


def tiny_vae_config(**kw) -> VAEConfig:
    return replace(VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_groups=8), **kw)


class VAEGroupNorm(GroupNorm):
    """GroupNorm (eps 1e-6) on K4; with `silu`, the SiLU after it too."""

    def __init__(self, channels: int, groups: int, silu: bool):
        super().__init__(channels, groups, 1e-6)
        self.silu = silu

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps, self.silu)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int,
                 dtype):
        super().__init__()
        self.norm1 = VAEGroupNorm(in_channels, groups, silu=True)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.norm2 = VAEGroupNorm(out_channels, groups, silu=True)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1,
                          dtype=dtype)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the pixels, residual; the attention
    itself on K5."""

    def __init__(self, channels: int, groups: int, dtype):
        super().__init__()
        self.group_norm = VAEGroupNorm(channels, groups, silu=False)
        self.to_q = Dense(channels, channels, dtype=dtype)
        self.to_k = Dense(channels, channels, dtype=dtype)
        self.to_v = Dense(channels, channels, dtype=dtype)
        self.to_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        o = self.to_out(vae_attention(self.to_q(y), self.to_k(y),
                                      self.to_v(y)))
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        dt, g = cfg.dtype, cfg.norm_groups
        self.conv_in = Conv(3, chs[0], 3, padding=1, dtype=dt)
        prev = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(cfg.layers_per_block):
                self.add_module(f"down_{bi}_res_{li}",
                                VAEResnet(prev, ch, g, dt))
                prev = ch
            if bi < len(chs) - 1:
                self.add_module(f"down_{bi}_downsample",
                                Conv(ch, ch, 3, stride=2,
                                     padding=((0, 1), (0, 1)), dtype=dt))
        self.mid_res_0 = VAEResnet(chs[-1], chs[-1], g, dt)
        self.mid_attn = VAEAttention(chs[-1], g, dt)
        self.mid_res_1 = VAEResnet(chs[-1], chs[-1], g, dt)
        self.conv_norm_out = VAEGroupNorm(chs[-1], g, silu=True)
        self.conv_out = Conv(chs[-1], 2 * cfg.latent_channels, 3, padding=1,
                             dtype=dt)

    def forward(self, x):
        cfg = self.cfg
        chs = cfg.block_out_channels
        h = self.conv_in(x.to(cfg.dtype).contiguous(
            memory_format=torch.channels_last))
        for bi in range(len(chs)):
            for li in range(cfg.layers_per_block):
                h = getattr(self, f"down_{bi}_res_{li}")(h)
            if bi < len(chs) - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chs = tuple(reversed(cfg.block_out_channels))
        dt, g = cfg.dtype, cfg.norm_groups
        self.conv_in = Conv(cfg.latent_channels, chs[0], 3, padding=1,
                            dtype=dt)
        self.mid_res_0 = VAEResnet(chs[0], chs[0], g, dt)
        self.mid_attn = VAEAttention(chs[0], g, dt)
        self.mid_res_1 = VAEResnet(chs[0], chs[0], g, dt)
        prev = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{bi}_res_{li}",
                                VAEResnet(prev, ch, g, dt))
                prev = ch
            if bi < len(chs) - 1:
                self.add_module(f"up_{bi}_upsample",
                                Conv(ch, ch, 3, padding=1, dtype=dt))
        self.conv_norm_out = VAEGroupNorm(chs[-1], g, silu=True)
        self.conv_out = Conv(chs[-1], 3, 3, padding=1, dtype=dt)

    def forward(self, z):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(z.to(cfg.dtype).contiguous(
            memory_format=torch.channels_last))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for bi in range(n):
            for li in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{bi}_res_{li}")(h)
            if bi < n - 1:
                h = getattr(self, f"up_{bi}_upsample")(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = self.post_quant_conv = None
        if cfg.quant_convs:
            self.quant_conv = Conv(2 * lc, 2 * lc, 1, dtype=cfg.dtype)
            self.post_quant_conv = Conv(lc, lc, 1, dtype=cfg.dtype)

    def encode_moments(self, images):
        """images [B, 3, H, W] in [-1, 1] -> (mean, logvar) latents."""
        m = self.encoder(images)
        if self.quant_conv is not None:
            m = self.quant_conv(m)
        mean, logvar = m.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images, eps=None):
        """-> scaled (and shifted) latents; with `eps` (the posterior's
        standard normal draw, shaped like the latents) samples the
        posterior, else its mean."""
        mean, logvar = self.encode_moments(images)
        z = mean
        if eps is not None:
            z = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        if self.cfg.shift_factor:
            z = z - self.cfg.shift_factor
        return z * self.cfg.scaling_factor

    def decode(self, latents):
        """scaled latents -> images [B, 3, H, W] in [-1, 1]."""
        z = latents / self.cfg.scaling_factor
        if self.cfg.shift_factor:
            z = z + self.cfg.shift_factor
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    def forward(self, images, eps=None):
        return self.decode(self.encode(images, eps))
