"""Plain FLUX.1-dev transformer and Union ControlNet, with IP identity
attention in the double-stream blocks: the reference for the port's
diffusion/flux.py, in plain PyTorch and float32.

Written from Black Forest Labs' reference code (flux/model.py,
flux/modules/layers.py: MLPEmbedder, RMSNorm, QKNorm, Modulation,
DoubleStreamBlock, SingleStreamBlock, LastLayer, EmbedND, rope,
apply_rope, timestep_embedding) and diffusers' FluxControlNetModel
(InstantX Union: controlnet_x_embedder, controlnet_mode_embedder,
controlnet_blocks, controlnet_single_blocks; the transformer adds sample
i // ceil(blocks / samples)) and FluxIPAdapterJointAttnProcessor2_0 (the
image query after its RMSNorm and before RoPE attends over to_k_ip(id),
to_v_ip(id); the result adds at ip_scale after the gated attention).

Departures from the published code, none of them in the arithmetic of a
layer:
  * the parameters carry the port's names, in the port's order (a double
    block's streams are `img` and `txt`, each with `mod`, `qkv`, `q_norm`,
    `k_norm`, `proj`, `fc1`, `fc2`; the final layer is `final_mod` and
    `final_linear`), so that benchmark/stack_flux.py gives both sides the
    same weights; the projections are gip_ref's Dense, so that
    lowp.quantised rounds each of them as every other dense layer;
  * everything runs in float32 (the published code runs at bf16, with
    float32 norm statistics and RoPE);
  * attention is written out (softmax(q k^T / sqrt(d)) v, in blocks of
    queries), in place of F.scaled_dot_product_attention;
  * the latents are taken and given as grids of packed tokens
    [B, h, w, 64], the ids made inside from the grid's size;
  * the ControlNet's residuals are not scaled by a conditioning scale (1
    in the guidance), and it is built for one mode;
  * the embedded guidance, sigma and the pooled vector are [B] and
    [B, P] per row.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import timestep_embedding
from .layers import Dense

EPS = 1e-6
THETA = 10000.0
MLP_RATIO = 4
QUERY_BLOCK = 1024  # queries a block of the written-out attention


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    patch_size: int = 1
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: tuple = (16, 56, 56)
    ip_tokens: int = 0
    ip_dim: int = 4096
    dtype: torch.dtype = torch.float32

    @property
    def hidden(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden(self) -> int:
        return self.hidden * MLP_RATIO


def rope(pos, dim: int, theta: float) -> torch.Tensor:
    """BFL's rope: pos [S] -> [S, dim / 2, 2, 2] rotation matrices."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64,
                         device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.double()[:, None] * omega[None]
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out),
                       torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def embed_nd(ids, axes_dims, theta: float) -> torch.Tensor:
    """ids [S, n_axes] -> [S, head_dim / 2, 2, 2]."""
    return torch.cat([rope(ids[:, i], d, theta)
                      for i, d in enumerate(axes_dims)], dim=-3)


def apply_rope(x, freqs):
    """x [B, H, S, D], freqs [S, D / 2, 2, 2] (BFL's apply_rope)."""
    x_ = x.float().reshape(*x.shape[:-1], -1, 1, 2)
    out = freqs[..., 0] * x_[..., 0] + freqs[..., 1] * x_[..., 1]
    return out.reshape(*x.shape)


def attention(q, k, v):
    """[B, H, S, D] -> [B, S, H D], written out, QUERY_BLOCK queries at a
    time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.cat([torch.softmax(q[:, :, i:i + QUERY_BLOCK] @ k.transpose(
        -1, -2) * scale, dim=-1) @ v
        for i in range(0, q.shape[2], QUERY_BLOCK)], dim=2)
    return out.transpose(1, 2).flatten(2)


def heads(x, n: int):
    """[B, S, H D] -> [B, H, S, D]."""
    return x.unflatten(-1, (n, -1)).transpose(1, 2)


def layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=EPS)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        rrms = torch.rsqrt(torch.mean(x.float() ** 2, dim=-1, keepdim=True)
                           + EPS)
        return x.float() * rrms * self.weight


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.in_layer = Dense(in_dim, dim)
        self.out_layer = Dense(dim, dim)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Stream(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden
        self.mod = Dense(d, 6 * d)
        self.qkv = Dense(d, 3 * d)
        self.q_norm = RMSNorm(cfg.attention_head_dim)
        self.k_norm = RMSNorm(cfg.attention_head_dim)
        self.proj = Dense(d, d)
        self.fc1 = Dense(d, cfg.mlp_hidden)
        self.fc2 = Dense(cfg.mlp_hidden, d)

    def qkv_heads(self, x, n: int):
        """-> q, k (normed), v, each [B, H, S, D]."""
        q, k, v = (heads(y, n) for y in self.qkv(x).chunk(3, dim=-1))
        return self.q_norm(q), self.k_norm(k), v

    def mlp(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.n = cfg.num_attention_heads
        self.img = Stream(cfg)
        self.txt = Stream(cfg)
        if cfg.ip_tokens > 0:
            self.to_k_ip = Dense(cfg.ip_dim, cfg.hidden)
            self.to_v_ip = Dense(cfg.ip_dim, cfg.hidden)

    def forward(self, img, txt, vec, pe, ip=None, ip_scale=1.0):
        n = self.n
        im = self.img.mod(F.silu(vec))[:, None].chunk(6, dim=-1)
        tm = self.txt.mod(F.silu(vec))[:, None].chunk(6, dim=-1)
        iq, ik, iv = self.img.qkv_heads((1 + im[1]) * layer_norm(img)
                                        + im[0], n)
        tq, tk, tv = self.txt.qkv_heads((1 + tm[1]) * layer_norm(txt)
                                        + tm[0], n)
        q = apply_rope(torch.cat([tq, iq], dim=2), pe)
        k = apply_rope(torch.cat([tk, ik], dim=2), pe)
        attn = attention(q, k, torch.cat([tv, iv], dim=2))
        t = txt.shape[1]
        img = img + im[2] * self.img.proj(attn[:, t:])
        if ip is not None:
            img = img + ip_scale * attention(
                iq, heads(self.to_k_ip(ip), n), heads(self.to_v_ip(ip), n))
        img = img + im[5] * self.img.mlp((1 + im[4]) * layer_norm(img)
                                         + im[3])
        txt = txt + tm[2] * self.txt.proj(attn[:, :t])
        txt = txt + tm[5] * self.txt.mlp((1 + tm[4]) * layer_norm(txt)
                                         + tm[3])
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden
        self.n = cfg.num_attention_heads
        self.d = d
        self.mod = Dense(d, 3 * d)
        self.linear1 = Dense(d, 3 * d + cfg.mlp_hidden)
        self.q_norm = RMSNorm(cfg.attention_head_dim)
        self.k_norm = RMSNorm(cfg.attention_head_dim)
        self.linear2 = Dense(d + cfg.mlp_hidden, d)

    def forward(self, x, vec, pe):
        shift, scale, gate = self.mod(F.silu(vec))[:, None].chunk(3, dim=-1)
        y = self.linear1((1 + scale) * layer_norm(x) + shift)
        qkv, mlp = y[..., :3 * self.d], y[..., 3 * self.d:]
        q, k, v = (heads(z, self.n) for z in qkv.chunk(3, dim=-1))
        q = apply_rope(self.q_norm(q), pe)
        k = apply_rope(self.k_norm(k), pe)
        attn = attention(q, k, v)
        out = self.linear2(torch.cat([attn, F.gelu(mlp, approximate="tanh")],
                                     dim=-1))
        return x + gate * out


def ids(txt_len: int, h: int, w: int, device) -> torch.Tensor:
    """[txt_len + h w, 3]: text (0, 0, 0), image token (i, j) (0, i, j)."""
    img = torch.zeros(h, w, 3, device=device)
    img[..., 1] = torch.arange(h, device=device)[:, None]
    img[..., 2] = torch.arange(w, device=device)[None, :]
    return torch.cat([torch.zeros(txt_len, 3, device=device),
                      img.reshape(h * w, 3)])


class _Trunk(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.img_in = Dense(cfg.in_channels, d)
        self.time_in = MLPEmbedder(256, d)
        self.guidance_in = (MLPEmbedder(256, d) if cfg.guidance_embeds
                            else None)
        self.vector_in = MLPEmbedder(cfg.pooled_projection_dim, d)
        self.txt_in = Dense(cfg.joint_attention_dim, d)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(cfg) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(cfg) for _ in range(cfg.num_single_layers))

    def _vec(self, sigma, guidance, pooled):
        vec = self.time_in(timestep_embedding(1000.0 * sigma, 256))
        if self.guidance_in is not None:
            vec = vec + self.guidance_in(timestep_embedding(
                1000.0 * guidance, 256))
        return vec + self.vector_in(pooled)

    def _pe(self, txt_len: int, h: int, w: int, device):
        return embed_nd(ids(txt_len, h, w, device), self.cfg.axes_dims_rope,
                        THETA)


class FluxTransformer(_Trunk):
    def __init__(self, cfg: FluxConfig):
        super().__init__(cfg)
        d = cfg.hidden
        self.final_mod = Dense(d, 2 * d)
        self.final_linear = Dense(d, cfg.in_channels)

    def forward(self, img, sigma, guidance, txt, pooled, ip=None,
                ip_scale: float = 1.0, controlnet=None):
        b, h, w, c = img.shape
        x = self.img_in(img.reshape(b, h * w, c))
        vec = self._vec(sigma, guidance, pooled)
        t = self.txt_in(txt)
        n_txt = t.shape[1]
        pe = self._pe(n_txt, h, w, img.device)
        doubles, singles = controlnet if controlnet is not None else ((),
                                                                     ())
        nd, ns = len(self.double_blocks), len(self.single_blocks)
        for i, block in enumerate(self.double_blocks):
            x, t = block(x, t, vec, pe, ip, ip_scale)
            if doubles:
                x = x + doubles[i // math.ceil(nd / len(doubles))]
        x = torch.cat([t, x], dim=1)
        for j, block in enumerate(self.single_blocks):
            x = block(x, vec, pe)
            if singles:
                s = singles[j // math.ceil(ns / len(singles))]
                x = torch.cat([x[:, :n_txt], x[:, n_txt:] + s], dim=1)
        shift, scale = self.final_mod(F.silu(vec))[:, None].chunk(2, dim=-1)
        x = x[:, n_txt:]
        x = self.final_linear((1 + scale) * layer_norm(x) + shift)
        return x.reshape(b, h, w, -1)


class FluxControlNet(_Trunk):
    def __init__(self, cfg: FluxConfig, num_mode: int = 10, mode: int = 4):
        super().__init__(cfg)
        d = cfg.hidden
        self.mode = mode
        self.controlnet_mode_embedder = nn.Embedding(num_mode, d)
        self.controlnet_x_embedder = Dense(cfg.in_channels, d)
        self.controlnet_blocks = nn.ModuleList(
            Dense(d, d) for _ in range(cfg.num_layers))
        self.controlnet_single_blocks = nn.ModuleList(
            Dense(d, d) for _ in range(cfg.num_single_layers))

    def forward(self, img, hint, sigma, guidance, txt, pooled):
        b, h, w, c = img.shape
        x = (self.img_in(img.reshape(b, h * w, c))
             + self.controlnet_x_embedder(hint.reshape(b, h * w, c)))
        vec = self._vec(sigma, guidance, pooled)
        t = self.txt_in(txt)
        mode = self.controlnet_mode_embedder(torch.full(
            (b, 1), self.mode, dtype=torch.long, device=img.device))
        t = torch.cat([mode, t], dim=1)
        n_txt = t.shape[1]
        pe = self._pe(n_txt, h, w, img.device)
        doubles = []
        for block in self.double_blocks:
            x, t = block(x, t, vec, pe)
            doubles.append(x)
        x = torch.cat([t, x], dim=1)
        singles = []
        for block in self.single_blocks:
            x = block(x, vec, pe)
            singles.append(x[:, n_txt:])
        return (tuple(z(s) for z, s in zip(self.controlnet_blocks, doubles)),
                tuple(z(s) for z, s in zip(self.controlnet_single_blocks,
                                           singles)))
