"""Plain SDXL UNet and ControlNet: the reference for the port's
diffusion/unet.py at SDXL base 1.0's widths, in plain PyTorch and float32.

Written from diffusers' UNet2DConditionModel and ControlNetModel as SDXL's
unet/config.json sets them up:
  * levels `block_out_channels`, `layers_per_block` ResNets each on the way
    down and one more on the way up, a stride-2 conv after every level but
    the last, a nearest x2 upsample and a 3x3 conv after every up level
    but the last;
  * on a level whose entry of `transformer_layers_per_block` is n > 0, a
    Transformer2DModel with n BasicTransformerBlocks after each ResNet;
    the up path reads the entries reversed, the mid block takes the last;
  * `attention_head_dim` is the head count of each level (diffusers reads
    SDXL's key so), the head width channels / heads;
  * Transformer2DModel with use_linear_projection: GroupNorm(eps 1e-6),
    Linear in over the [B, hw, C] sequence, the blocks, Linear out,
    residual;
  * the "text_time" added embedding: each of the 6 time ids through the
    sinusoidal Timesteps(addition_time_embed_dim, flip_sin_to_cos, shift
    0), flattened after the pooled text, through add_embedding (Linear,
    SiLU, Linear) and added to the time embedding; the ControlNet has its
    own.

Departures from diffusers, none of them in the arithmetic of a layer:
  * the parameters carry the port's (flax) names, in the port's order, so
    that benchmark/inputs.random_weights gives both sides the same
    weights; the layers are gip_ref's (Dense, Conv, LayerNorm, GroupNorm,
    Conv3x3 as F.conv2d), so lowp.quantised rounds the projections and the
    added embedding as every other dense layer;
  * the config states 0 blocks for the first level, where SDXL's config
    says 1 for a DownBlock2D / UpBlock2D that has no attention to use it;
  * the UNet's cross-attentions carry IP-Adapter FaceID PlusV2 SDXL's
    to_k_ip / to_v_ip over the last `ip_tokens` tokens of the context,
    added at `ip_scale`; its LoRA is folded into the base weights (rank 0);
  * attention is written out (softmax(q k^T / sqrt(d)) v, in blocks of
    queries), in place of F.scaled_dot_product_attention;
  * the ControlNet has no guess mode and scales its residuals by
    `conditioning_scale`, as the port's.
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
    TransformerBlock,
    Upsample,
    timestep_embedding,
)
from .layers import Conv, Dense
from .norm import GroupNorm


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 2048
    attention_head_dim: tuple = (5, 10, 20)
    norm_groups: int = 32
    lora_rank: int = 0
    ip_tokens: int = 0
    dtype: torch.dtype = torch.float32
    transformer_layers_per_block: tuple = (0, 2, 10)
    use_linear_projection: bool = True
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    def __post_init__(self):
        if not (self.use_linear_projection and self.addition_time_embed_dim
                and self.lora_rank == 0):
            raise ValueError("the SDXL reference has linear projections, "
                             "the added embedding and no LoRA")


class Transformer2D(nn.Module):
    """diffusers Transformer2DModel with use_linear_projection."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int,
                 n_blocks: int, ip_tokens: int, groups: int):
        super().__init__()
        self.n_blocks = n_blocks
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = Dense(channels, channels)
        for i in range(n_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                channels, heads, cross_attention_dim, 0, ip_tokens))
        self.proj_out = Dense(channels, channels)

    def forward(self, x, context, ip_scale: float):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for i in range(self.n_blocks):
            y, _ = getattr(self, f"block_{i}")(y, context, ip_scale)
        y = self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return y + x


class _Encoder(nn.Module):
    """The time and added embeddings, conv_in, the down path and the mid
    block, as the UNet and the ControlNet both have them."""

    def _build_encoder(self, cfg: UNetConfig, ip_tokens: int):
        chs = cfg.block_out_channels
        g = cfg.norm_groups
        temb = chs[0] * 4
        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, padding=1)
        self.skip_channels = [chs[0]]
        prev = chs[0]
        for bi, ch in enumerate(chs):
            depth = cfg.transformer_layers_per_block[bi]
            for li in range(cfg.layers_per_block):
                self.add_module(f"down_{bi}_res_{li}",
                                ResnetBlock(prev, ch, temb, g))
                if depth:
                    self.add_module(f"down_{bi}_attn_{li}", Transformer2D(
                        ch, cfg.attention_head_dim[bi],
                        cfg.cross_attention_dim, depth, ip_tokens, g))
                prev = ch
                self.skip_channels.append(ch)
            if bi < len(chs) - 1:
                self.add_module(f"down_{bi}_downsample", Downsample(ch))
                self.skip_channels.append(ch)
        mid_depth = [d for d in cfg.transformer_layers_per_block if d][-1]
        self.mid_res_0 = ResnetBlock(chs[-1], chs[-1], temb, g)
        self.mid_attn = Transformer2D(
            chs[-1], cfg.attention_head_dim[-1], cfg.cross_attention_dim,
            mid_depth, ip_tokens, g)
        self.mid_res_1 = ResnetBlock(chs[-1], chs[-1], temb, g)

    def _embed(self, timesteps, pooled, ids):
        cfg = self.cfg
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]))
        tid = timestep_embedding(ids.reshape(-1),
                                 cfg.addition_time_embed_dim)
        add = torch.cat([pooled, tid.reshape(ids.shape[0], -1)], dim=-1)
        return temb + self.add_embedding(add)

    def _encode(self, h, temb, context, ip_scale):
        """-> (mid output, the skips: conv_in's output and every down
        layer's)"""
        cfg = self.cfg
        skips = [h]
        n = len(cfg.block_out_channels)
        for bi in range(n):
            for li in range(cfg.layers_per_block):
                h = getattr(self, f"down_{bi}_res_{li}")(h, temb)
                if cfg.transformer_layers_per_block[bi]:
                    h = getattr(self, f"down_{bi}_attn_{li}")(h, context,
                                                              ip_scale)
                skips.append(h)
            if bi < n - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                skips.append(h)
        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context, ip_scale)
        return self.mid_res_1(h, temb), skips


class UNet2DConditionModel(_Encoder):
    """SDXL's UNet with the IP-Adapter's identity tokens; forward as the
    port's (no VCR modes)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self._build_encoder(cfg, cfg.ip_tokens)
        chs = cfg.block_out_channels
        g = cfg.norm_groups
        temb = chs[0] * 4
        skips = list(self.skip_channels)
        prev = chs[-1]
        n = len(chs)
        for bi in range(n):
            level = n - 1 - bi
            ch = chs[level]
            depth = cfg.transformer_layers_per_block[level]
            for li in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{bi}_res_{li}", ResnetBlock(
                    prev + skips.pop(), ch, temb, g))
                if depth:
                    self.add_module(f"up_{bi}_attn_{li}", Transformer2D(
                        ch, cfg.attention_head_dim[level],
                        cfg.cross_attention_dim, depth, cfg.ip_tokens, g))
                prev = ch
            if bi < n - 1:
                self.add_module(f"up_{bi}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm(chs[0], g, 1e-5)
        self.conv_out = Conv(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_residuals=None, mid_block_residual=None,
                ip_scale: float = 1.0, added_cond=None):
        """added_cond: (pooled text [B, P], time ids [B, 6])."""
        cfg = self.cfg
        temb = self._embed(timesteps, *added_cond)
        h, skips = self._encode(self.conv_in(sample), temb,
                                encoder_hidden_states, ip_scale)
        if down_block_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_block_residuals)]
        if mid_block_residual is not None:
            h = h + mid_block_residual
        n = len(cfg.block_out_channels)
        for bi in range(n):
            for li in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{bi}_res_{li}")(
                    torch.cat([h, skips.pop()], dim=1), temb)
                if cfg.transformer_layers_per_block[n - 1 - bi]:
                    h = getattr(self, f"up_{bi}_attn_{li}")(
                        h, encoder_hidden_states, ip_scale)
            if bi < n - 1:
                h = getattr(self, f"up_{bi}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class ControlNetModel(_Encoder):
    """SDXL's ControlNet: the UNet's encoder without identity tokens, the
    conditioning image's conv pyramid added after conv_in, and a 1x1 conv
    on every skip and on the mid output."""

    def __init__(self, cfg: UNetConfig, conditioning_channels: int = 3,
                 conditioning_embed_channels: tuple = (16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        self._build_encoder(cfg, 0)
        emb = conditioning_embed_channels
        self.n_cond = len(emb) - 1
        self.cond_conv_in = Conv(conditioning_channels, emb[0], 3, padding=1)
        for i in range(self.n_cond):
            self.add_module(f"cond_conv_{2 * i}",
                            Conv(emb[i], emb[i], 3, padding=1))
            self.add_module(f"cond_conv_{2 * i + 1}",
                            Conv(emb[i], emb[i + 1], 3, stride=2, padding=1))
        self.cond_conv_out = Conv(emb[-1], cfg.block_out_channels[0], 3,
                                  padding=1)
        for i, ch in enumerate(self.skip_channels):
            self.add_module(f"zero_conv_{i}", Conv(ch, ch, 1))
        ch = cfg.block_out_channels[-1]
        self.zero_conv_mid = Conv(ch, ch, 1)

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image,
                conditioning_scale: float = 1.0, ip_scale: float = 1.0,
                added_cond=None):
        """-> ([residual per skip], mid residual)."""
        temb = self._embed(timesteps, *added_cond)
        c = F.silu(self.cond_conv_in(cond_image))
        for i in range(self.n_cond):
            c = F.silu(getattr(self, f"cond_conv_{2 * i}")(c))
            c = F.silu(getattr(self, f"cond_conv_{2 * i + 1}")(c))
        h = self.conv_in(sample) + self.cond_conv_out(c)
        h, skips = self._encode(h, temb, encoder_hidden_states, ip_scale)
        out = [getattr(self, f"zero_conv_{i}")(s) * conditioning_scale
               for i, s in enumerate(skips)]
        return out, self.zero_conv_mid(h) * conditioning_scale
