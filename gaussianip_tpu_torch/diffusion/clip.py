"""The CLIP text and vision transformers (the models the JAX package takes
from transformers' FlaxCLIPTextModel / FlaxCLIPVisionModel,
gaussianip_tpu/system/pipeline.py:99-132), in PyTorch.

  * `CLIPTextModel`: token + position embeddings, pre-LN encoder layers
    under a causal mask, `final_layer_norm`; returns `last_hidden_state`
    [N, S, D] (SD1.5's CLIP-L: 12 x 768, 12 heads, quick_gelu).
  * `CLIPVisionModel`: a patch-embedding conv, the class embedding,
    `pre_layrnorm`, pre-LN encoder layers; returns the penultimate hidden
    state [N, 1 + patches, D] (transformers' `hidden_states[-2]`: the
    output of every layer but the last, with no post-layernorm), as the
    IP-Adapter-FaceID-Plus reads it (ViT-H/14: 32 x 1280, 16 heads, gelu).

Parameter names are transformers' state-dict keys
(`text_model.encoder.layers.0.self_attn.q_proj.weight`, ...), so a
checkpoint loads with `load_state_dict(strict=True)`. Configs come from
the checkpoint's config.json, with transformers' defaults for missing
keys; the vision tower of a full CLIPModel checkpoint reads its nested
`vision_config` and its `vision_model.*` weights only. Everything runs in
float32.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


def config_from_dict(cls, d: dict):
    """The config's fields from a config.json dict; missing keys take
    transformers' defaults, unknown keys are ignored."""
    names = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unsupported CLIP hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, causal: bool):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)), is_causal=causal)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.act = _activation(act)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(d, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, causal: bool, n_layers: int | None = None):
        for layer in self.layers[:n_layers]:
            x = layer(x, causal)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids):
        return self.token_embedding(ids) + \
            self.position_embedding.weight[:ids.shape[1]]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, ids):
        return self.final_layer_norm(
            self.encoder(self.embeddings(ids), causal=True))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        """ids [N, S] int64 -> last_hidden_state [N, S, D] float32."""
        return self.text_model(ids)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size,
                                         cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        # loaded with the checkpoint; the penultimate state skips it
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        return self.encoder(x, causal=False, n_layers=len(self.encoder.layers)
                            - 1)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixels):
        """pixels [N, 3, H, W] (normalised) -> the penultimate hidden
        state [N, 1 + patches, D] float32."""
        return self.vision_model(pixels)


def _checkpoint(model_dir: str) -> str:
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no CLIP weights under {model_dir} (tried model.safetensors, "
        f"pytorch_model.bin)")


def _load(model_dir: str, prefix: str, make, device):
    from .weights import load_torch_state_dict

    sd = load_torch_state_dict(_checkpoint(model_dir))
    # transformers' position_ids buffer is not a parameter here
    sd = {k: v for k, v in sd.items()
          if k.startswith(prefix) and not k.endswith("position_ids")}
    with torch.device("meta"):
        model = make()
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval().requires_grad_(False)


def _config_json(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_clip_text(model_dir: str, device="cuda") -> CLIPTextModel:
    """A transformers CLIPTextModel directory (config.json + weights)."""
    d = _config_json(model_dir)
    d = d.get("text_config", d)
    cfg = config_from_dict(CLIPTextConfig, d)
    return _load(model_dir, "text_model.", lambda: CLIPTextModel(cfg),
                 device)


def load_clip_vision(model_dir: str, device="cuda") -> CLIPVisionModel:
    """A transformers CLIPVisionModel or full CLIPModel directory; of a
    CLIPModel, the nested vision_config and the vision_model.* weights."""
    d = _config_json(model_dir)
    if "vision_config" in d or "vision_config_dict" in d:
        d = {**(d.get("vision_config") or {}),
             **(d.get("vision_config_dict") or {})}
    cfg = config_from_dict(CLIPVisionConfig, d)
    return _load(model_dir, "vision_model.", lambda: CLIPVisionModel(cfg),
                 device)
