"""Building blocks of the SD1.5- and SDXL-class UNet / ControlNet (port
of gaussianip_tpu/diffusion/blocks.py), NCHW in channels_last memory.

Submodules carry the flax names (`norm1`, `conv1`, `to_q.main`, ...), so
`diffusion/from_flax.py` is a tree walk. Attention runs
F.scaled_dot_product_attention, as the JAX package runs XLA's
dot_product_attention; its chunked online-softmax path is an XLA memory
workaround with the same result and is not ported. Sequences are [B, S, D].

Stage 2's VCR mutual attention rides on the self-attention of the first
transformer block of a Transformer2D, as an op dict `vcr`:
  {"mode": "store"}: plain self-attention; the block returns the hidden
    states the layer received (its norm1 output) for later views;
  {"mode": "key", "src": [B, S', D]}: attends over cat(self, src) along
    the sequence, and also stores;
  {"mode": "dense", "src_l", "src_r": [B, S', D], "w_l", "w_r",
    "lambda_self": floats}: lambda_self * self-attention + (1 -
    lambda_self) * (w_l * attention into src_l + w_r * into src_r).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import Conv3x3
from ..utils.profiling import span
from .layers import Conv, Dense, LayerNorm
from .norm import GroupNorm


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim] in float32 (diffusers
    convention for SD1.5)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * t[:, None].float()
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim, dtype=dtype)
        self.linear_2 = Dense(dim, dim, dtype=dtype)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_dim: int, groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, 1e-5)
        self.conv1 = Conv3x3(in_channels, out_channels, dtype=dtype)
        self.time_emb_proj = Dense(temb_dim, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(out_channels, groups, 1e-5)
        self.conv2 = Conv3x3(out_channels, out_channels, dtype=dtype)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class LoRADense(nn.Module):
    """Dense with an optional LoRA adapter: y = W x + scale * B(A(x))."""

    def __init__(self, in_features: int, features: int, lora_rank: int = 0,
                 lora_scale: float = 1.0, use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.lora_scale = lora_scale
        self.main = Dense(in_features, features, use_bias, dtype)
        if lora_rank > 0:
            self.lora_down = Dense(in_features, lora_rank, False, dtype)
            self.lora_up = Dense(lora_rank, features, False, dtype)
        else:
            self.lora_down = self.lora_up = None

    def forward(self, x):
        y = self.main(x)
        if self.lora_down is not None:
            y = y + self.lora_scale * self.lora_up(self.lora_down(x))
        return y


def attend(q, k, v, heads: int) -> torch.Tensor:
    """[B, S, D] multi-head scaled dot-product attention."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // heads
    o = F.scaled_dot_product_attention(
        q.reshape(b, sq, heads, hd).transpose(1, 2),
        k.reshape(b, sk, heads, hd).transpose(1, 2),
        v.reshape(b, sk, heads, hd).transpose(1, 2))
    return o.transpose(1, 2).reshape(b, sq, d)


class Attention(nn.Module):
    """Self- or cross-attention with LoRA and IP-Adapter tokens: with
    `ip_tokens` > 0 the last ip_tokens of the context attend through
    to_k_ip / to_v_ip and add with `ip_scale`. Self-attention takes a VCR
    op (`vcr`, see the module docstring); what `store` and `key` keep is
    `hidden_states` itself, which the caller holds."""

    def __init__(self, query_dim: int, heads: int,
                 cross_attention_dim: int | None = None, lora_rank: int = 0,
                 ip_tokens: int = 0, dtype=torch.float32):
        super().__init__()
        d = query_dim
        kv_dim = cross_attention_dim or d
        self.heads = heads
        self.ip_tokens = ip_tokens
        self.to_q = LoRADense(d, d, lora_rank, use_bias=False, dtype=dtype)
        self.to_k = LoRADense(kv_dim, d, lora_rank, use_bias=False,
                              dtype=dtype)
        self.to_v = LoRADense(kv_dim, d, lora_rank, use_bias=False,
                              dtype=dtype)
        self.to_out = LoRADense(d, d, lora_rank, use_bias=True, dtype=dtype)
        if cross_attention_dim is not None and ip_tokens > 0:
            self.to_k_ip = Dense(kv_dim, d, False, dtype)
            self.to_v_ip = Dense(kv_dim, d, False, dtype)

    def _over(self, q, kv):
        return attend(q, self.to_k(kv), self.to_v(kv), self.heads)

    def forward(self, hidden_states, encoder_hidden_states=None,
                ip_scale: float = 1.0, vcr: dict | None = None):
        q = self.to_q(hidden_states)
        mode = "off" if vcr is None else vcr["mode"]
        if encoder_hidden_states is not None and self.ip_tokens > 0:
            txt = encoder_hidden_states[:, :-self.ip_tokens]
            ip = encoder_hidden_states[:, -self.ip_tokens:]
            out = self._over(q, txt)
            out = out + ip_scale * attend(q, self.to_k_ip(ip),
                                          self.to_v_ip(ip), self.heads)
        elif encoder_hidden_states is not None:
            out = self._over(q, encoder_hidden_states)
        elif mode == "key":
            out = self._over(q, torch.cat([hidden_states, vcr["src"]], 1))
        elif mode == "dense":
            lam = vcr["lambda_self"]
            out = lam * self._over(q, hidden_states) + (1.0 - lam) * (
                vcr["w_l"] * self._over(q, vcr["src_l"])
                + vcr["w_r"] * self._over(q, vcr["src_r"]))
        elif mode in ("off", "store"):
            out = self._over(q, hidden_states)
        else:
            raise ValueError(f"unknown VCR mode {mode!r}")
        return self.to_out(out)


class FeedForward(nn.Module):
    """GEGLU with the exact (erf) GELU, as diffusers."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.geglu_proj = Dense(dim, inner * 2, dtype=dtype)
        self.out_proj = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        h, gate = self.geglu_proj(x).chunk(2, dim=-1)
        return self.out_proj(h * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_attention_dim: int,
                 lora_rank: int = 0, ip_tokens: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn1 = Attention(dim, heads, lora_rank=lora_rank, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.attn2 = Attention(dim, heads, cross_attention_dim, lora_rank,
                               ip_tokens, dtype)
        self.norm3 = LayerNorm(dim, 1e-5, dtype)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x, context, ip_scale: float = 1.0,
                vcr: dict | None = None):
        """-> (x, the self-attention's input in the store / key VCR modes,
        else None)."""
        h = self.norm1(x)
        stored = h if vcr is not None and vcr["mode"] in ("store",
                                                         "key") else None
        x = x + self.attn1(h, vcr=vcr)
        x = x + self.attn2(self.norm2(x), context, ip_scale)
        return x + self.ff(self.norm3(x)), stored


class Transformer2D(nn.Module):
    """GroupNorm -> projection in -> `n_blocks` transformer blocks ->
    projection out, residual (diffusers Transformer2DModel). The
    projections are 1x1 convs on [B, C, h, w] (SD1.5,
    use_linear_projection=False) or, with `linear_projection`, Dense layers
    on the [B, hw, C] sequence (SDXL, use_linear_projection=True). A VCR op
    goes to the first block only; returns (out, its stored states or
    None). Each call is the span `transformer`."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int,
                 n_blocks: int = 1, lora_rank: int = 0, ip_tokens: int = 0,
                 groups: int = 32, linear_projection: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        proj = (partial(Dense, channels, channels, dtype=dtype)
                if linear_projection
                else partial(Conv, channels, channels, 1, dtype=dtype))
        self.linear_projection = linear_projection
        self.proj_in = proj()
        for i in range(n_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                channels, heads, cross_attention_dim, lora_rank, ip_tokens,
                dtype))
        self.blocks = [getattr(self, f"block_{i}") for i in range(n_blocks)]
        self.proj_out = proj()

    def forward(self, x, context, ip_scale: float = 1.0,
                vcr: dict | None = None):
        with span("transformer"):
            b, c, h, w = x.shape
            seq = lambda y: y.permute(0, 2, 3, 1).reshape(b, h * w, c)
            if self.linear_projection:
                y = self.proj_in(seq(self.norm(x)))
            else:
                y = seq(self.proj_in(self.norm(x)))
            y, stored = self.blocks[0](y, context, ip_scale, vcr)
            for block in self.blocks[1:]:
                y, _ = block(y, context, ip_scale)
            if self.linear_projection:
                y = self.proj_out(y)
            y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
            if not self.linear_projection:
                y = self.proj_out(y)
            return y + x, stored


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3x3(channels, channels, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
