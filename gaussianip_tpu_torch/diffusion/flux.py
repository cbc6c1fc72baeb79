"""FLUX.1-dev's rectified-flow transformer (an MMDiT) and the Union
ControlNet for it, with IP identity attention in the double-stream
blocks: the velocity prior that stage 1's AHDS guidance can run in place
of a UNet (guidance/ipa.py, through `FluxTransformer.prediction`).

Written from Black Forest Labs' reference code (flux/model.py,
flux/modules/layers.py) and diffusers' FluxTransformer2DModel,
FluxControlNetModel and FluxIPAdapterJointAttnProcessor2_0:

  * vec = time_in(emb(1000 sigma)) + guidance_in(emb(1000 g)) +
    vector_in(pooled), each an MLP (Linear, SiLU, Linear); emb is the
    256-wide sinusoid in [cos, sin] order;
  * a double-stream block keeps separate weights for the image and the
    text tokens: (shift, scale, gate) x 2 = Linear(SiLU(vec)); x~ =
    (1 + scale1) LN(x) + shift1 (LayerNorm without affine, eps 1e-6); q,
    k, v from qkv(x~), q and k RMS-normed (eps 1e-6, a learned scale of
    the head's width); attention jointly over cat(txt, img) with RoPE on
    q and k; x += gate1 proj(attn), then x += gate2 MLP((1 + scale2) LN(x)
    + shift2), the MLP GELU(tanh) between two Linears;
  * IP identity attention (the 19 double blocks, the image stream): ip =
    attention(q_img after its RMSNorm and before RoPE, to_k_ip(id),
    to_v_ip(id)); x_img += ip_scale ip after the gated attention, with no
    gate and no output projection;
  * a single-stream block on cat(txt, img): (shift, scale, gate) =
    Linear(SiLU(vec)); linear1(x~) splits into qkv and an MLP input side
    by side; x += gate linear2(cat(attn, GELU_tanh(mlp)));
  * RoPE: three axes of 16 / 56 / 56 of each 128-wide head, theta 10,000,
    on interleaved pairs, the angles in float64 and the rotation in
    float32; text ids (0, 0, 0), image token (i, j) id (0, i, j);
  * the final layer: adaLN (shift, scale), then Linear to the 64 packed
    channels;
  * the ControlNet (InstantX Union): its own embedders and 5 + 10 blocks;
    the hint (the VAE-encoded pose map, packed) goes through
    `controlnet_x_embedder` and adds to img_in(x); the mode's embedding is
    one more text token, first, with a zero id; each block's image tokens
    go through a zero-initialised Linear. The transformer adds sample
    i // ceil(19 / 5) after double block i and sample j // ceil(38 / 10) to
    the image tokens after single block j.

The latents are packed 2 x 2 (`pack`): [B, 16, H, W] -> a grid of
[B, H/2, W/2, 64] tokens, channels in (c, ph, pw) order; both networks
take and the transformer returns such grids.

Parameters are held at the configuration's dtype (bf16 on the card: the
float32 masters of the 15.7 B parameters with the ControlNet and the IP
projections would not fit beside a step). LayerNorm and RMSNorm
statistics and RoPE are computed in float32, the rest at the dtype, as
the published code runs at bf16. The structure is fixed when a module is
built. Attention is `blocks.attend` (F.scaled_dot_product_attention).
Each block is the span `double_block` or `single_block`
(utils/profiling.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span
from .blocks import attend, timestep_embedding
from .layers import Dense

EPS = 1e-6
TIME_FACTOR = 1000.0
EMBED_DIM = 256  # the sinusoid of sigma and of g
THETA = 10000.0  # RoPE's base
MLP_RATIO = 4


@dataclass(frozen=True)
class FluxConfig:
    """transformer/config.json of FLUX.1-dev (patch_size 1: the 2 x 2
    packing of the latents is the patch) and the IP identity attention's
    tokens and width (0 tokens: none)."""
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
    dtype: torch.dtype = torch.bfloat16

    @property
    def hidden(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden(self) -> int:
        return self.hidden * MLP_RATIO


def pack(latents: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H/2, W/2, 4C], each 2 x 2 patch a token."""
    b, c, h, w = latents.shape
    return latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(b, h // 2, w // 2, 4 * c)


def unpack(tokens: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack`: [B, h, w, 4C] -> [B, C, 2h, 2w]."""
    b, h, w, c4 = tokens.shape
    return tokens.reshape(b, h, w, c4 // 4, 2, 2).permute(
        0, 3, 1, 4, 2, 5).reshape(b, c4 // 4, 2 * h, 2 * w)


def rope_freqs(axes_dims, txt_len: int, h: int, w: int,
               device) -> torch.Tensor:
    """The rotations of the tokens cat(txt_len text, h x w image), as unit
    complex numbers [S, 1, head_dim / 2] (complex64): per axis a of width
    d, pair i turns by id_a * THETA ** (-2i / d)."""
    ids = torch.zeros(txt_len + h * w, 3, dtype=torch.float64,
                      device=device)
    ii, jj = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    ids[txt_len:, 1] = ii.reshape(-1).double()
    ids[txt_len:, 2] = jj.reshape(-1).double()
    angles = torch.cat([ids[:, a, None] * THETA ** -(torch.arange(
        0, d, 2, dtype=torch.float64, device=device) / d)
        for a, d in enumerate(axes_dims)], dim=-1)
    return torch.complex(torch.cos(angles).float(),
                         torch.sin(angles).float())[:, None]


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]: each pair (x[2i], x[2i + 1]) turned by freqs
    [S, 1, D / 2], in float32; -> x's dtype."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * freqs).flatten(-2).to(x.dtype)


def _modulate(x, shift, scale):
    """(1 + scale) LN(x) + shift; LayerNorm without affine, eps 1e-6."""
    return torch.addcmul(shift, F.layer_norm(x, x.shape[-1:], eps=EPS),
                         1 + scale)


class RMSNorm(nn.Module):
    """The scale of a q or k RMSNorm; `qk_norm` applies a pair."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))


def qk_norm(qkv: torch.Tensor, q_norm: RMSNorm, k_norm: RMSNorm,
            heads: int):
    """qkv [B, S, 3 D] -> (q and k [2, B, S, H, D / H], each RMS-normed in
    float32 and scaled by its own weight; v [B, S, H, D / H])."""
    x = qkv.unflatten(-1, (3, heads, -1))
    w = torch.stack([q_norm.weight, k_norm.weight])[:, None, None, None]
    qk = F.rms_norm(x[:, :, :2].movedim(2, 0), x.shape[-1:], eps=EPS) * w
    return qk, x[:, :, 2]


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype):
        super().__init__()
        self.in_layer = Dense(in_dim, dim, dtype=dtype, param_dtype=dtype)
        self.out_layer = Dense(dim, dim, dtype=dtype, param_dtype=dtype)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Stream(nn.Module):
    """One stream's weights in a double block: modulation, qkv with the q
    and k norms, the attention's projection and the MLP."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d, dt = cfg.hidden, cfg.dtype
        dense = lambda i, o: Dense(i, o, dtype=dt, param_dtype=dt)
        self.mod = dense(d, 6 * d)
        self.qkv = dense(d, 3 * d)
        self.q_norm = RMSNorm(cfg.attention_head_dim, dt)
        self.k_norm = RMSNorm(cfg.attention_head_dim, dt)
        self.proj = dense(d, d)
        self.fc1 = dense(d, cfg.mlp_hidden)
        self.fc2 = dense(cfg.mlp_hidden, d)

    def mlp(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.img = Stream(cfg)
        self.txt = Stream(cfg)
        self.ip = cfg.ip_tokens > 0
        if self.ip:
            d, dt = cfg.hidden, cfg.dtype
            self.to_k_ip = Dense(cfg.ip_dim, d, dtype=dt, param_dtype=dt)
            self.to_v_ip = Dense(cfg.ip_dim, d, dtype=dt, param_dtype=dt)

    def forward(self, img, txt, vec, freqs, ip=None, ip_scale=1.0):
        """img [B, N, D], txt [B, T, D], vec [B, D], freqs of cat(txt,
        img); ip [B, ip_tokens, ip_dim] or None -> (img, txt)."""
        with span("double_block"):
            h = self.heads
            t = txt.shape[1]
            im = self.img.mod(F.silu(vec))[:, None].chunk(6, dim=-1)
            tm = self.txt.mod(F.silu(vec))[:, None].chunk(6, dim=-1)
            iqk, iv = qk_norm(self.img.qkv(_modulate(img, im[0], im[1])),
                              self.img.q_norm, self.img.k_norm, h)
            tqk, tv = qk_norm(self.txt.qkv(_modulate(txt, tm[0], tm[1])),
                              self.txt.q_norm, self.txt.k_norm, h)
            qk = apply_rope(torch.cat([tqk, iqk], dim=2), freqs)
            v = torch.cat([tv, iv], dim=1)
            attn = attend(qk[0].flatten(2), qk[1].flatten(2), v.flatten(2),
                          h)
            img = torch.addcmul(img, im[2], self.img.proj(attn[:, t:]))
            if self.ip and ip is not None:
                img = torch.add(img, attend(
                    iqk[0].flatten(2), self.to_k_ip(ip), self.to_v_ip(ip), h),
                    alpha=ip_scale)
            img = torch.addcmul(img, im[5], self.img.mlp(
                _modulate(img, im[3], im[4])))
            txt = torch.addcmul(txt, tm[2], self.txt.proj(attn[:, :t]))
            txt = torch.addcmul(txt, tm[5], self.txt.mlp(
                _modulate(txt, tm[3], tm[4])))
            return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d, dt = cfg.hidden, cfg.dtype
        self.heads = cfg.num_attention_heads
        self.split = (3 * d, cfg.mlp_hidden)
        self.mod = Dense(d, 3 * d, dtype=dt, param_dtype=dt)
        self.linear1 = Dense(d, 3 * d + cfg.mlp_hidden, dtype=dt,
                             param_dtype=dt)
        self.q_norm = RMSNorm(cfg.attention_head_dim, dt)
        self.k_norm = RMSNorm(cfg.attention_head_dim, dt)
        self.linear2 = Dense(d + cfg.mlp_hidden, d, dtype=dt, param_dtype=dt)

    def forward(self, x, vec, freqs):
        """x [B, S, D] (text tokens first) -> x."""
        with span("single_block"):
            shift, scale, gate = self.mod(F.silu(vec))[:, None].chunk(
                3, dim=-1)
            qkv, mlp = self.linear1(_modulate(x, shift, scale)).split(
                self.split, dim=-1)
            qk, v = qk_norm(qkv, self.q_norm, self.k_norm, self.heads)
            qk = apply_rope(qk, freqs)
            attn = attend(qk[0].flatten(2), qk[1].flatten(2), v.flatten(2),
                          self.heads)
            out = self.linear2(torch.cat(
                [attn, F.gelu(mlp, approximate="tanh")], dim=-1))
            return torch.addcmul(x, gate, out)


class _Trunk(nn.Module):
    """What the transformer and the ControlNet share: the embedders and
    the two kinds of block."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d, dt = cfg.hidden, cfg.dtype
        self.cfg = cfg
        self.axes = tuple(cfg.axes_dims_rope)
        self.img_in = Dense(cfg.in_channels, d, dtype=dt, param_dtype=dt)
        self.time_in = MLPEmbedder(EMBED_DIM, d, dt)
        self.guidance_in = (MLPEmbedder(EMBED_DIM, d, dt)
                            if cfg.guidance_embeds else None)
        self.vector_in = MLPEmbedder(cfg.pooled_projection_dim, d, dt)
        self.txt_in = Dense(cfg.joint_attention_dim, d, dtype=dt,
                            param_dtype=dt)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(cfg) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(cfg) for _ in range(cfg.num_single_layers))

    def _vec(self, sigma, guidance, pooled):
        vec = self.time_in(timestep_embedding(TIME_FACTOR * sigma,
                                              EMBED_DIM))
        if self.guidance_in is not None:
            vec = vec + self.guidance_in(timestep_embedding(
                TIME_FACTOR * guidance, EMBED_DIM))
        return vec + self.vector_in(pooled)


def _interval(blocks: int, samples: int) -> int:
    return math.ceil(blocks / samples)


class FluxTransformer(_Trunk):
    """FLUX.1's transformer; with cfg.ip_tokens > 0, the IP projections in
    every double block."""

    # what the denoiser predicts (guidance/ipa.py reads it)
    prediction = "velocity"

    def __init__(self, cfg: FluxConfig):
        super().__init__(cfg)
        d, dt = cfg.hidden, cfg.dtype
        self.final_mod = Dense(d, 2 * d, dtype=dt, param_dtype=dt)
        self.final_linear = Dense(d, cfg.in_channels, dtype=dt,
                                  param_dtype=dt)

    def forward(self, img, sigma, guidance, txt, pooled, ip=None,
                ip_scale: float = 1.0, controlnet=None):
        """img [B, h, w, in_channels] packed latents, sigma [B] the flow's
        noise level, guidance [B] g, txt [B, T, joint_attention_dim],
        pooled [B, pooled_projection_dim], ip [B, ip_tokens, ip_dim] or
        None; controlnet: FluxControlNet's (double samples, single
        samples) or None -> the velocity [B, h, w, in_channels] at the
        dtype."""
        b, h, w, c = img.shape
        x = self.img_in(img.reshape(b, h * w, c))
        vec = self._vec(sigma, guidance, pooled)
        t = self.txt_in(txt)
        n_txt = t.shape[1]
        freqs = rope_freqs(self.axes, n_txt, h, w, img.device)
        doubles, singles = controlnet if controlnet is not None else ((),
                                                                     ())
        for i, block in enumerate(self.double_blocks):
            x, t = block(x, t, vec, freqs, ip, ip_scale)
            if doubles:
                x = x + doubles[i // _interval(len(self.double_blocks),
                                               len(doubles))]
        x = torch.cat([t, x], dim=1)
        for j, block in enumerate(self.single_blocks):
            x = block(x, vec, freqs)
            if singles:
                x[:, n_txt:] += singles[j // _interval(
                    len(self.single_blocks), len(singles))]
        shift, scale = self.final_mod(F.silu(vec))[:, None].chunk(2, dim=-1)
        x = self.final_linear(_modulate(x[:, n_txt:], shift, scale))
        return x.reshape(b, h, w, -1)


class FluxControlNet(_Trunk):
    """The Union ControlNet in one of its `num_mode` modes (`mode`; the
    OpenPose mode is 4): cfg's num_layers and num_single_layers blocks
    (5 and 10 for FLUX.1-dev's), no IP attention."""

    def __init__(self, cfg: FluxConfig, num_mode: int = 10, mode: int = 4):
        super().__init__(cfg)
        d, dt = cfg.hidden, cfg.dtype
        self.mode = mode
        self.controlnet_mode_embedder = nn.Embedding(num_mode, d, dtype=dt)
        self.controlnet_x_embedder = Dense(cfg.in_channels, d, dtype=dt,
                                           param_dtype=dt)
        self.controlnet_blocks = nn.ModuleList(
            Dense(d, d, dtype=dt, param_dtype=dt)
            for _ in range(cfg.num_layers))
        self.controlnet_single_blocks = nn.ModuleList(
            Dense(d, d, dtype=dt, param_dtype=dt)
            for _ in range(cfg.num_single_layers))

    def forward(self, img, hint, sigma, guidance, txt, pooled):
        """img, hint [B, h, w, in_channels] (the packed latents and the
        packed pose latents), the rest as FluxTransformer's -> (a sample
        [B, h w, D] per double block, one per single block)."""
        b, h, w, c = img.shape
        x = self.img_in(img.reshape(b, h * w, c)) + \
            self.controlnet_x_embedder(hint.reshape(b, h * w, c))
        vec = self._vec(sigma, guidance, pooled)
        t = self.txt_in(txt)
        mode = self.controlnet_mode_embedder.weight[self.mode]
        t = torch.cat([mode.to(t.dtype).expand(b, 1, -1), t], dim=1)
        n_txt = t.shape[1]
        freqs = rope_freqs(self.axes, n_txt, h, w, img.device)
        doubles = []
        for block, zero in zip(self.double_blocks, self.controlnet_blocks):
            x, t = block(x, t, vec, freqs)
            doubles.append(zero(x))
        x = torch.cat([t, x], dim=1)
        singles = []
        for block, zero in zip(self.single_blocks,
                               self.controlnet_single_blocks):
            x = block(x, vec, freqs)
            singles.append(zero(x[:, n_txt:]))
        return tuple(doubles), tuple(singles)
