"""IP-Adapter-FaceID-Plus projection heads (port of
gaussianip_tpu/diffusion/ip_adapter.py).

ProjPlusModel projects the 512-d ArcFace identity embedding to
num_tokens x 768 tokens and resamples them over the CLIP-ViT-H hidden
states with a 4-layer perceiver; with `shortcut` it returns
tokens + scale * resampled. GELU here is the tanh approximation (flax's
default nn.gelu), as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, LayerNorm


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16,
                 dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.to_q = Dense(dim, inner, False, dtype)
        self.to_kv = Dense(dim, inner * 2, False, dtype)
        self.to_out = Dense(inner, dim, False, dtype)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        heads = lambda t: t.reshape(b, t.shape[1], self.heads,
                                    self.dim_head).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        scale = 1.0 / math.sqrt(math.sqrt(self.dim_head))
        w = (q * scale) @ (k * scale).transpose(-2, -1)
        w = torch.softmax(w.float(), dim=-1).to(w.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, l, -1)
        return self.to_out(out)


class ResamplerFF(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim, 1e-5, dtype)
        self.fc1 = Dense(dim, dim * mult, False, dtype)
        self.fc2 = Dense(dim * mult, dim, False, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="tanh"))


class _Perceiver(nn.Module):
    """proj_in, depth x (attention + FF, residual), proj_out, norm_out."""

    def _build(self, dim, depth, dim_head, heads, embedding_dim, output_dim,
               ff_mult, dtype):
        self.depth = depth
        self.proj_in = Dense(embedding_dim, dim, dtype=dtype)
        for i in range(depth):
            self.add_module(f"attn_{i}",
                            PerceiverAttention(dim, dim_head, heads, dtype))
            self.add_module(f"ff_{i}", ResamplerFF(dim, ff_mult, dtype))
        self.proj_out = Dense(dim, output_dim, dtype=dtype)
        self.norm_out = LayerNorm(output_dim, 1e-5, dtype)

    def _run(self, latents, x):
        x = self.proj_in(x)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x, latents) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        return self.norm_out(self.proj_out(latents))


class FacePerceiverResampler(_Perceiver):
    def __init__(self, dim: int = 768, depth: int = 4, dim_head: int = 64,
                 heads: int = 16, embedding_dim: int = 1280,
                 output_dim: int = 768, ff_mult: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self._build(dim, depth, dim_head, heads, embedding_dim, output_dim,
                    ff_mult, dtype)

    def forward(self, latents, x):
        return self._run(latents, x)


class ProjPlusModel(nn.Module):
    def __init__(self, cross_attention_dim: int = 768,
                 id_embeddings_dim: int = 512,
                 clip_embeddings_dim: int = 1280, num_tokens: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.num_tokens = num_tokens
        self.cross_attention_dim = cross_attention_dim
        self.proj_fc1 = Dense(id_embeddings_dim, id_embeddings_dim * 2,
                              dtype=dtype)
        self.proj_fc2 = Dense(id_embeddings_dim * 2,
                              cross_attention_dim * num_tokens, dtype=dtype)
        self.norm = LayerNorm(cross_attention_dim, 1e-5, dtype)
        self.perceiver_resampler = FacePerceiverResampler(
            dim=cross_attention_dim, heads=cross_attention_dim // 64,
            embedding_dim=clip_embeddings_dim,
            output_dim=cross_attention_dim, dtype=dtype)

    def forward(self, id_embeds, clip_embeds, shortcut: bool = False,
                scale: float = 1.0):
        """id_embeds [B, 512]; clip_embeds [B, 257, 1280] -> [B,
        num_tokens, 768]."""
        x = F.gelu(self.proj_fc1(id_embeds), approximate="tanh")
        x = self.proj_fc2(x).reshape(-1, self.num_tokens,
                                     self.cross_attention_dim)
        x = self.norm(x)
        out = self.perceiver_resampler(x, clip_embeds)
        if shortcut:
            out = x + scale * out
        return out


class Resampler(_Perceiver):
    """Perceiver resampler of the non-FaceID IP-Adapter-Plus: learned
    latent queries attend over the CLIP hidden states."""

    def __init__(self, dim: int = 768, depth: int = 4, dim_head: int = 64,
                 heads: int = 12, num_queries: int = 16,
                 embedding_dim: int = 1280, output_dim: int = 768,
                 ff_mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(1, num_queries, dim))
        self._build(dim, depth, dim_head, heads, embedding_dim, output_dim,
                    ff_mult, dtype)

    def forward(self, x):
        """x [B, S, embedding_dim] -> [B, num_queries, output_dim]."""
        latents = self.latents.expand(x.shape[0], -1, -1)
        return self._run(latents, x)


def ipa_plus_image_embeds(resampler: Resampler, clip_hidden,
                          zero_clip_hidden):
    """Non-FaceID IPAdapterPlus embed pair: (cond tokens, uncond tokens)."""
    return resampler(clip_hidden), resampler(zero_clip_hidden)
