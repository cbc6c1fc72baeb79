"""SD1.5- and SDXL-class conditional UNet with ControlNet residual
inputs, and the ControlNet (port of gaussianip_tpu/diffusion/unet.py),
NCHW in channels_last memory.

`UNetConfig` holds what the two families differ in, per level:
  * `transformer_layers_per_block`: the transformer blocks of each
    attention layer of a level, 0 for a level without attention. None is
    SD1.5's rule: one block on every level but the last. SDXL is (0, 2,
    10): its first level (DownBlock2D / UpBlock2D) has none. The mid block
    takes the last nonzero entry; the up path reads the levels reversed;
  * `attention_head_dim`: the head COUNT of each level (an int for all),
    as the JAX package and diffusers' SD configs read the key: SD1.5's 8
    heads at every width, SDXL's (5, 10, 20), 64 wide each;
  * `use_linear_projection`: Dense projections in and out of each
    Transformer2D (SDXL) in place of 1x1 convs (SD1.5);
  * `addition_time_embed_dim`, `projection_class_embeddings_input_dim`:
    SDXL's "text_time" added embedding (0: none). The forward then takes
    `added_cond` = (pooled text [B, P], time ids [B, 6]); each id is
    embedded sinusoidally at addition_time_embed_dim, concatenated after
    the pooled text and, through `add_embedding`, added to the time
    embedding of every ResNet, in the UNet and the ControlNet alike.
The module tree is resolved when it is built: a forward walks prebuilt
lists of its submodules and reads no config.

Stage 2's VCR modes (`store`, `key`, `dense`, see diffusion/blocks.py)
ride on the self-attention of the up path's attention layers (every up
level with attention, `layers_per_block + 1` layers each: 9 at SD1.5
widths, 6 at SDXL's). Submodules carry the flax names.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
    attention_head_dim: int | tuple = 8
    norm_groups: int = 32
    lora_rank: int = 0
    ip_tokens: int = 0
    dtype: torch.dtype = torch.float32
    transformer_layers_per_block: tuple | None = None
    use_linear_projection: bool = False
    addition_time_embed_dim: int = 0
    projection_class_embeddings_input_dim: int = 0

    @property
    def depths(self) -> tuple:
        """Transformer blocks per attention layer of each level (0: the
        level has no attention)."""
        if self.transformer_layers_per_block is None:
            n = len(self.block_out_channels)
            return (1,) * (n - 1) + (0,)
        return tuple(self.transformer_layers_per_block)

    @property
    def heads(self) -> tuple:
        """The head count of each level."""
        h = self.attention_head_dim
        return (tuple(h) if isinstance(h, (tuple, list))
                else (h,) * len(self.block_out_channels))

    @property
    def n_vcr_layers(self) -> int:
        return sum(d > 0 for d in self.depths) * (self.layers_per_block + 1)


def tiny_unet_config(**kw) -> UNetConfig:
    """Small config for tests."""
    return replace(UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                              cross_attention_dim=32, attention_head_dim=4,
                              norm_groups=8), **kw)


def time_ids(height: int, width: int, batch: int, device) -> torch.Tensor:
    """SDXL's micro-conditioning of a height x width image, [batch, 6]
    float32: original size (h, w), crop top-left (0, 0), target size (h,
    w)."""
    row = torch.tensor([height, width, 0, 0, height, width],
                       dtype=torch.float32, device=device)
    return row.expand(batch, 6)


def _transformer(cfg: UNetConfig, ch: int, depth: int, heads: int,
                 adapters: bool):
    """The UNet's attention carries the config's LoRA and IP tokens, the
    ControlNet's neither."""
    return Transformer2D(ch, heads, cfg.cross_attention_dim, depth,
                         lora_rank=cfg.lora_rank if adapters else 0,
                         ip_tokens=cfg.ip_tokens if adapters else 0,
                         groups=cfg.norm_groups,
                         linear_projection=cfg.use_linear_projection,
                         dtype=cfg.dtype)


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
    """Time embedding (with SDXL's added embedding), conv_in, the down
    blocks and the mid block, shared by the UNet and the ControlNet (the
    same flax names in both)."""

    def _build_down_mid(self, cfg: UNetConfig, adapters: bool):
        chs = cfg.block_out_channels
        dt = cfg.dtype
        g = cfg.norm_groups
        temb_dim = chs[0] * 4
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim, dt)
        if cfg.addition_time_embed_dim:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim, dt)
        else:
            self.add_embedding = None
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, padding=1, dtype=dt)
        self.down_channels = [chs[0]]
        # per level: ([(resnet, transformer or None)], downsample or None)
        self.down_path = []
        prev = chs[0]
        for bi, (ch, depth, heads) in enumerate(zip(chs, cfg.depths,
                                                    cfg.heads)):
            layers = []
            for li in range(cfg.layers_per_block):
                res = ResnetBlock(prev, ch, temb_dim, g, dt)
                self.add_module(f"down_{bi}_res_{li}", res)
                attn = None
                if depth:
                    attn = _transformer(cfg, ch, depth, heads, adapters)
                    self.add_module(f"down_{bi}_attn_{li}", attn)
                layers.append((res, attn))
                prev = ch
                self.down_channels.append(ch)
            down = None
            if bi < len(chs) - 1:
                down = Downsample(ch, dt)
                self.add_module(f"down_{bi}_downsample", down)
                self.down_channels.append(ch)
            self.down_path.append((layers, down))
        mid_depth = [d for d in cfg.depths if d][-1]
        self.mid_res_0 = ResnetBlock(chs[-1], chs[-1], temb_dim, g, dt)
        self.mid_attn = _transformer(cfg, chs[-1], mid_depth, cfg.heads[-1],
                                     adapters)
        self.mid_res_1 = ResnetBlock(chs[-1], chs[-1], temb_dim, g, dt)

    def _temb(self, timesteps, added_cond):
        cfg = self.cfg
        emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(emb.to(cfg.dtype))
        if self.add_embedding is None:
            if added_cond is not None:
                raise ValueError("added_cond given to a model without the "
                                 "added embedding")
            return temb
        if added_cond is None:
            raise ValueError("the added embedding needs added_cond = "
                             "(pooled text [B, P], time ids [B, 6])")
        pooled, ids = added_cond
        tid = timestep_embedding(ids.flatten(), cfg.addition_time_embed_dim)
        add = torch.cat([pooled.float(), tid.reshape(pooled.shape[0], -1)],
                        dim=-1)
        return temb + self.add_embedding(add.to(cfg.dtype))

    def _conv_in(self, sample):
        x = sample.to(self.cfg.dtype).contiguous(
            memory_format=torch.channels_last)
        return self.conv_in(x)

    def _down_mid(self, h, temb, context, ip_scale):
        """-> (mid output, [conv_in output, every down block output])"""
        res = [h]
        for layers, down in self.down_path:
            for resnet, attn in layers:
                h = resnet(h, temb)
                if attn is not None:
                    h, _ = attn(h, context, ip_scale)
                res.append(h)
            if down is not None:
                h = down(h)
                res.append(h)
        h = self.mid_res_0(h, temb)
        h, _ = self.mid_attn(h, context, ip_scale)
        return self.mid_res_1(h, temb), res


class UNet2DConditionModel(_DownMid):
    # what the denoiser predicts (guidance/ipa.py reads it)
    prediction = "epsilon"

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self._build_down_mid(cfg, True)
        chs = cfg.block_out_channels
        dt = cfg.dtype
        g = cfg.norm_groups
        temb_dim = chs[0] * 4
        skips = list(self.down_channels)
        # per level: ([(resnet, transformer or None)], upsample or None)
        self.up_path = []
        prev = chs[-1]
        for bi, (ch, depth, heads) in enumerate(zip(
                reversed(chs), reversed(cfg.depths), reversed(cfg.heads))):
            layers = []
            for li in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                res = ResnetBlock(prev + skip, ch, temb_dim, g, dt)
                self.add_module(f"up_{bi}_res_{li}", res)
                attn = None
                if depth:
                    attn = _transformer(cfg, ch, depth, heads, True)
                    self.add_module(f"up_{bi}_attn_{li}", attn)
                layers.append((res, attn))
                prev = ch
            up = None
            if bi < len(chs) - 1:
                up = Upsample(ch, dt)
                self.add_module(f"up_{bi}_upsample", up)
            self.up_path.append((layers, up))
        self.conv_norm_out = GroupNorm(chs[0], g, 1e-5)
        self.conv_out = Conv(chs[0], cfg.out_channels, 3, padding=1, dtype=dt)

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_residuals=None, mid_block_residual=None,
                ip_scale: float = 1.0, vcr_mode: str = "off",
                vcr_cache=None, vcr_weights: dict | None = None,
                added_cond=None):
        """sample [B, C, h, w] latents, timesteps [B], context [B, S, D];
        ControlNet residuals add to the skips and the mid output;
        added_cond (pooled [B, P], time ids [B, 6]) with the added
        embedding, and only then. Returns the noise prediction [B,
        out_channels, h, w] at the config's dtype; with a VCR mode other
        than "off", the pair (prediction, cache): in `store` and `key`
        modes the list of the VCR layers' stored [B, S_l, D_l] states in
        layer order, in `dense` None. vcr_cache: `key`, one source [B,
        S_l, D_l] per VCR layer; `dense`, a pair of such lists (left,
        right); vcr_weights: `dense`, {"w_l", "w_r", "lambda_self"}."""
        temb = self._temb(timesteps, added_cond)
        h, res = self._down_mid(self._conv_in(sample), temb,
                                encoder_hidden_states, ip_scale)
        if down_block_residuals is not None:
            res = [r + c for r, c in zip(res, down_block_residuals)]
        if mid_block_residual is not None:
            h = h + mid_block_residual
        cache, layer = [], 0
        for layers, up in self.up_path:
            for resnet, attn in layers:
                # rebinding h first frees the pre-concat tensor for the call
                h = torch.cat([h, res.pop()], dim=1)
                h = resnet(h, temb)
                if attn is not None:
                    h, stored = attn(
                        h, encoder_hidden_states, ip_scale,
                        _vcr_op(vcr_mode, vcr_cache, vcr_weights, layer))
                    if stored is not None:
                        cache.append(stored)
                    layer += 1
            if up is not None:
                h = up(h)
        out = self.conv_out(F.silu(self.conv_norm_out(h)))
        if vcr_mode == "off":
            return out
        return out, (cache if vcr_mode in ("store", "key") else None)


class ControlNetModel(_DownMid):
    """ControlNet: the UNet's down + mid path, a conditioning-image
    embedding (stride-2 conv pyramid) added after conv_in, and 1x1 output
    convs per residual (lllyasviel control_v11p_sd15_openpose shape; at
    SDXL widths the full encoder copy, as thibaud/controlnet-openpose-
    sdxl-1.0, with the added embedding). The config's LoRA and ip_tokens
    do not apply: its cross-attention attends over the whole context
    through to_k / to_v."""

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
                conditioning_scale: float = 1.0, ip_scale: float = 1.0,
                added_cond=None):
        """cond_image [B, 3, H, W] -> ([residual per skip], mid residual);
        added_cond as the UNet takes it."""
        temb = self._temb(timesteps, added_cond)
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
