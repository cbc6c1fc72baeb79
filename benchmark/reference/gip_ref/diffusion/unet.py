"""Frozen copy of gaussianip_tpu_torch/diffusion/unet.py, plain PyTorch.

SD1.5-class conditional UNet with ControlNet residual inputs, and the
ControlNet (port of gaussianip_tpu/diffusion/unet.py), NCHW in
channels_last memory.

Stage 2's VCR modes (`store`, `key`, `dense`, see diffusion/blocks.py)
ride on the self-attention of the up blocks' transformers (every up block
but the first, `layers_per_block + 1` each: 9 layers at SD1.5 widths).
Heads: `attention_head_dim` is the head COUNT (8), as in the JAX package.
Submodules carry the flax names.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import (
    Downsample,
    ResnetBlock,
    TimestepEmbedding,
    Transformer2D,
    Upsample,
    timestep_embedding,
)
from .layers import Conv
from .norm import GroupNorm


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    norm_groups: int = 32
    lora_rank: int = 0
    ip_tokens: int = 0
    dtype: torch.dtype = torch.float32

    @property
    def n_vcr_layers(self) -> int:
        return (len(self.block_out_channels) - 1) * (self.layers_per_block
                                                     + 1)


def _transformer(cfg: UNetConfig, ch: int, adapters: bool):
    """The UNet's attention carries the config's LoRA and IP tokens, the
    ControlNet's neither."""
    return Transformer2D(ch, cfg.attention_head_dim, cfg.cross_attention_dim,
                         lora_rank=cfg.lora_rank if adapters else 0,
                         ip_tokens=cfg.ip_tokens if adapters else 0,
                         groups=cfg.norm_groups, dtype=cfg.dtype)


def _vcr_op(mode: str, cache, weights, layer: int) -> dict | None:
    """The VCR op of up-path layer `layer` (see diffusion/blocks.py)."""
    if mode == "off":
        return None
    if mode == "store":
        return {"mode": "store"}
    if mode == "key":
        return {"mode": "key", "src": cache[layer]}
    if mode == "dense":
        return {"mode": "dense", "src_l": cache[0][layer],
                "src_r": cache[1][layer], **weights}
    raise ValueError(f"unknown VCR mode {mode!r}")


class _DownMid(nn.Module):
    """Time embedding, conv_in, the down blocks and the mid block, shared
    by the UNet and the ControlNet (the same flax names in both)."""

    def _build_down_mid(self, cfg: UNetConfig, adapters: bool):
        chs = cfg.block_out_channels
        dt = cfg.dtype
        g = cfg.norm_groups
        temb_dim = chs[0] * 4
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim, dt)
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, padding=1, dtype=dt)
        self.down_channels = [chs[0]]
        prev = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(cfg.layers_per_block):
                self.add_module(f"down_{bi}_res_{li}",
                                ResnetBlock(prev, ch, temb_dim, g, dt))
                if bi < len(chs) - 1:
                    self.add_module(f"down_{bi}_attn_{li}",
                                    _transformer(cfg, ch, adapters))
                prev = ch
                self.down_channels.append(ch)
            if bi < len(chs) - 1:
                self.add_module(f"down_{bi}_downsample", Downsample(ch, dt))
                self.down_channels.append(ch)
        self.mid_res_0 = ResnetBlock(chs[-1], chs[-1], temb_dim, g, dt)
        self.mid_attn = _transformer(cfg, chs[-1], adapters)
        self.mid_res_1 = ResnetBlock(chs[-1], chs[-1], temb_dim, g, dt)

    def _temb(self, timesteps):
        cfg = self.cfg
        emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        return self.time_embedding(emb.to(cfg.dtype))

    def _conv_in(self, sample):
        x = sample.to(self.cfg.dtype).contiguous(
            memory_format=torch.channels_last)
        return self.conv_in(x)

    def _down_mid(self, h, temb, context, ip_scale):
        """-> (mid output, [conv_in output, every down block output])"""
        cfg = self.cfg
        chs = cfg.block_out_channels
        res = [h]
        for bi in range(len(chs)):
            for li in range(cfg.layers_per_block):
                h = getattr(self, f"down_{bi}_res_{li}")(h, temb)
                if bi < len(chs) - 1:
                    h, _ = getattr(self, f"down_{bi}_attn_{li}")(
                        h, context, ip_scale)
                res.append(h)
            if bi < len(chs) - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                res.append(h)
        h = self.mid_res_0(h, temb)
        h, _ = self.mid_attn(h, context, ip_scale)
        return self.mid_res_1(h, temb), res


class UNet2DConditionModel(_DownMid):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self._build_down_mid(cfg, True)
        chs = cfg.block_out_channels
        dt = cfg.dtype
        g = cfg.norm_groups
        temb_dim = chs[0] * 4
        skips = list(self.down_channels)
        prev = chs[-1]
        for bi, ch in enumerate(reversed(chs)):
            for li in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                self.add_module(f"up_{bi}_res_{li}",
                                ResnetBlock(prev + skip, ch, temb_dim, g, dt))
                if bi > 0:
                    self.add_module(f"up_{bi}_attn_{li}",
                                    _transformer(cfg, ch, True))
                prev = ch
            if bi < len(chs) - 1:
                self.add_module(f"up_{bi}_upsample", Upsample(ch, dt))
        self.conv_norm_out = GroupNorm(chs[0], g, 1e-5)
        self.conv_out = Conv(chs[0], cfg.out_channels, 3, padding=1, dtype=dt)

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_residuals=None, mid_block_residual=None,
                ip_scale: float = 1.0, vcr_mode: str = "off",
                vcr_cache=None, vcr_weights: dict | None = None):
        """sample [B, C, h, w] latents, timesteps [B], context [B, S, D];
        ControlNet residuals add to the skips and the mid output. Returns
        the noise prediction [B, out_channels, h, w] at the config's
        dtype; with a VCR mode other than "off", the pair (prediction,
        cache): in `store` and `key` modes the list of the VCR layers'
        stored [B, S_l, D_l] states in layer order, in `dense` None.
        vcr_cache: `key`, one source [B, S_l, D_l] per VCR layer; `dense`,
        a pair of such lists (left, right); vcr_weights: `dense`, {"w_l",
        "w_r", "lambda_self"}."""
        cfg = self.cfg
        temb = self._temb(timesteps)
        h, res = self._down_mid(self._conv_in(sample), temb,
                                encoder_hidden_states, ip_scale)
        if down_block_residuals is not None:
            res = [r + c for r, c in zip(res, down_block_residuals)]
        if mid_block_residual is not None:
            h = h + mid_block_residual
        n = len(cfg.block_out_channels)
        cache, layer = [], 0
        for bi in range(n):
            for li in range(cfg.layers_per_block + 1):
                h = torch.cat([h, res.pop()], dim=1)
                h = getattr(self, f"up_{bi}_res_{li}")(h, temb)
                if bi > 0:
                    h, stored = getattr(self, f"up_{bi}_attn_{li}")(
                        h, encoder_hidden_states, ip_scale,
                        _vcr_op(vcr_mode, vcr_cache, vcr_weights, layer))
                    if stored is not None:
                        cache.append(stored)
                    layer += 1
            if bi < n - 1:
                h = getattr(self, f"up_{bi}_upsample")(h)
        out = self.conv_out(F.silu(self.conv_norm_out(h)))
        if vcr_mode == "off":
            return out
        return out, (cache if vcr_mode in ("store", "key") else None)


class ControlNetModel(_DownMid):
    """ControlNet: the UNet's down + mid path, a conditioning-image
    embedding (stride-2 conv pyramid) added after conv_in, and 1x1 output
    convs per residual (lllyasviel control_v11p_sd15_openpose shape). The
    config's LoRA and ip_tokens do not apply: its cross-attention attends
    over the whole context through to_k / to_v."""

    def __init__(self, cfg: UNetConfig, conditioning_channels: int = 3,
                 conditioning_embed_channels: tuple = (16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        self._build_down_mid(cfg, False)
        dt = cfg.dtype
        emb = conditioning_embed_channels
        self.n_cond = len(emb) - 1
        self.cond_conv_in = Conv(conditioning_channels, emb[0], 3, padding=1,
                                 dtype=dt)
        for i in range(len(emb) - 1):
            self.add_module(f"cond_conv_{2 * i}",
                            Conv(emb[i], emb[i], 3, padding=1, dtype=dt))
            self.add_module(f"cond_conv_{2 * i + 1}",
                            Conv(emb[i], emb[i + 1], 3, stride=2, padding=1,
                                 dtype=dt))
        self.cond_conv_out = Conv(emb[-1], cfg.block_out_channels[0], 3,
                                  padding=1, dtype=dt)
        for i, ch in enumerate(self.down_channels):
            self.add_module(f"zero_conv_{i}", Conv(ch, ch, 1, dtype=dt))
        ch = cfg.block_out_channels[-1]
        self.zero_conv_mid = Conv(ch, ch, 1, dtype=dt)

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image,
                conditioning_scale: float = 1.0, ip_scale: float = 1.0):
        """cond_image [B, 3, H, W] -> ([residual per skip], mid residual)."""
        temb = self._temb(timesteps)
        h = self._conv_in(sample)
        c = cond_image.to(self.cfg.dtype).contiguous(
            memory_format=torch.channels_last)
        c = F.silu(self.cond_conv_in(c))
        for i in range(self.n_cond):
            c = F.silu(getattr(self, f"cond_conv_{2 * i}")(c))
            c = F.silu(getattr(self, f"cond_conv_{2 * i + 1}")(c))
        h = h + self.cond_conv_out(c)
        h, res = self._down_mid(h, temb, encoder_hidden_states, ip_scale)
        out = [getattr(self, f"zero_conv_{i}")(r) * conditioning_scale
               for i, r in enumerate(res)]
        return out, self.zero_conv_mid(h) * conditioning_scale
