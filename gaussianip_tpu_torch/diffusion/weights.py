"""Checkpoint files and the diffusers-layout converters (port of
gaussianip_tpu/diffusion/weights.py).

Files:
  * `.safetensors`: read here (`read_safetensors`; the writer is in
    system/standin.py): an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}} with an optional
    `__metadata__`, then the raw bytes. No `safetensors` package is needed.
  * `.bin` / `.pth`: `torch.load(weights_only=True)`; the released files
    are (nested) dicts of tensors.

Converters: the released diffusers state dicts (Realistic_Vision_V4.0_noVAE
UNet, sd-vae-ft-mse, control_v11p_sd15_openpose and the `image_proj` /
`ip_adapter` dicts of ip-adapter-faceid-plusv2_sd15.bin) become the flax
parameter trees of the JAX package, key for key and array for array
(numpy), which `diffusion/from_flax.py` carries into the port's modules:

  torch Linear  [out, in]          -> flax Dense kernel [in, out]
  torch Conv2d  [out, in, kh, kw]  -> flax Conv kernel  [kh, kw, in, out]
  norm weight/bias                 -> scale/bias

The inverse maps (`export_*`), which write released-layout files from
random modules for the tests and chip_smoke.py, are in system/standin.py.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

# ---------------------------------------------------------------------------
# .safetensors / .bin files
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str):
    """-> ({name: CPU tensor in the file's dtype}, metadata dict). The
    tensors share one buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.seek(0, 2) - 8 - n)
        f.seek(8 + n)
        f.readinto(buf)
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        dt = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = info["shape"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        count = (end - start) // torch.empty((), dtype=dt).element_size()
        out[name] = torch.frombuffer(buf, dtype=dt, count=count,
                                     offset=start).reshape(shape)
    return out, meta


def _float32(x):
    if isinstance(x, dict):
        return {k: _float32(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.float()
    return x


def load_torch_state_dict(path: str, keep_dtype: bool = False) -> Dict:
    """A .safetensors / .bin / .pth checkpoint -> {name: CPU tensor}, the
    floating-point ones float32 (integer tensors keep their dtype); nested
    dicts (the IP-Adapter's `image_proj` / `ip_adapter`) stay dicts of such
    tensors, and a top-level `state_dict` entry is unwrapped.

    keep_dtype: .safetensors tensors keep the file's dtype, as the JAX
    package's loader returns them (its `fold_lora` rounds each folded
    kernel to that dtype); .bin / .pth are float32 either way, as there."""
    if path.endswith(".safetensors"):
        sd, _ = read_safetensors(path)
        return sd if keep_dtype else _float32(sd)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return _float32(sd)


# ---------------------------------------------------------------------------
# diffusers state dict -> flax parameter tree
# ---------------------------------------------------------------------------


def _arr(x) -> np.ndarray:
    """A state-dict entry as numpy: float16 / float32 as they are, bfloat16
    widened to float32 (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _t_linear(w):
    return _arr(w).T


def _t_conv(w):
    return _arr(w).transpose(2, 3, 1, 0)


def _norm(sd, prefix):
    return {"scale": _arr(sd[f"{prefix}.weight"]),
            "bias": _arr(sd[f"{prefix}.bias"])}


def _conv(sd, prefix):
    return {"kernel": _t_conv(sd[f"{prefix}.weight"]),
            "bias": _arr(sd[f"{prefix}.bias"])}


def _dense(sd, prefix, bias=True):
    out = {"kernel": _t_linear(sd[f"{prefix}.weight"])}
    if bias:
        out["bias"] = _arr(sd[f"{prefix}.bias"])
    return out


def _resnet(sd, p):
    out = {
        "norm1": _norm(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _dense(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _lora_dense(sd, p, bias, lora=None):
    """LoRADense: main + optional lora_down/up (from the IP-Adapter
    processor state, keys '<idx>.to_q_lora.down.weight' etc.)."""
    out = {"main": _dense(sd, p, bias=bias)}
    if lora is not None:
        down, up = lora
        out["lora_down"] = {"kernel": _t_linear(down)}
        out["lora_up"] = {"kernel": _t_linear(up)}
    return out


def fold_lora(params, scale: float = 1.0):
    """Fold LoRA adapters into the base kernels: W' = W + scale * A @ B,
    computed in float32 and rounded to W's dtype, as the JAX package folds.
    The IP-Adapter's LoRA runs at a static scale, so the fold is exact for
    the forward and for gradients with respect to the inputs; the folded
    tree fits a lora_rank=0 module."""
    if not isinstance(params, dict):
        return params
    # a LoRADense node has exactly these keys
    if set(params.keys()) == {"main", "lora_down", "lora_up"}:
        main = dict(params["main"])
        a = np.asarray(params["lora_down"]["kernel"], np.float32)
        b = np.asarray(params["lora_up"]["kernel"], np.float32)
        k = np.asarray(main["kernel"], np.float32)
        main["kernel"] = (k + scale * (a @ b)).astype(
            np.asarray(main["kernel"]).dtype)
        return {"main": main}
    return {k: fold_lora(v, scale) for k, v in params.items()}


def _attention(sd, p, ip: bool = False, lora_sd: Dict | None = None,
               lora_prefix: str = ""):
    def lora_pair(name):
        if lora_sd is None:
            return None
        dk = f"{lora_prefix}.{name}_lora.down.weight"
        if dk not in lora_sd:
            return None
        return (lora_sd[dk], lora_sd[f"{lora_prefix}.{name}_lora.up.weight"])

    out = {
        "to_q": _lora_dense(sd, f"{p}.to_q", False, lora_pair("to_q")),
        "to_k": _lora_dense(sd, f"{p}.to_k", False, lora_pair("to_k")),
        "to_v": _lora_dense(sd, f"{p}.to_v", False, lora_pair("to_v")),
        "to_out": _lora_dense(sd, f"{p}.to_out.0", True, lora_pair("to_out")),
    }
    if ip and lora_sd is not None:
        out["to_k_ip"] = {"kernel": _t_linear(
            lora_sd[f"{lora_prefix}.to_k_ip.weight"])}
        out["to_v_ip"] = {"kernel": _t_linear(
            lora_sd[f"{lora_prefix}.to_v_ip.weight"])}
    return out


def _transformer2d(sd, p, lora_sd=None, lora_idx_attn1="", lora_idx_attn2=""):
    tb = f"{p}.transformer_blocks.0"
    block = {
        "norm1": _norm(sd, f"{tb}.norm1"),
        "attn1": _attention(sd, f"{tb}.attn1", ip=False, lora_sd=lora_sd,
                            lora_prefix=lora_idx_attn1),
        "norm2": _norm(sd, f"{tb}.norm2"),
        "attn2": _attention(sd, f"{tb}.attn2", ip=True, lora_sd=lora_sd,
                            lora_prefix=lora_idx_attn2),
        "norm3": _norm(sd, f"{tb}.norm3"),
        "ff": {
            "geglu_proj": _dense(sd, f"{tb}.ff.net.0.proj"),
            "out_proj": _dense(sd, f"{tb}.ff.net.2"),
        },
    }
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "proj_in": _conv(sd, f"{p}.proj_in"),
        "block_0": block,
        "proj_out": _conv(sd, f"{p}.proj_out"),
    }


def attention_prefixes(n: int, layers_per_block: int):
    """(port name, diffusers prefix) of the UNet's transformers in the
    IP-Adapter checkpoint's numbering order (diffusers' attn_processors:
    down blocks, up blocks, then mid)."""
    down = [(f"down_{bi}_attn_{li}", f"down_blocks.{bi}.attentions.{li}")
            for bi in range(n - 1) for li in range(layers_per_block)]
    up = [(f"up_{bi}_attn_{li}", f"up_blocks.{bi}.attentions.{li}")
          for bi in range(1, n) for li in range(layers_per_block + 1)]
    return down + up + [("mid_attn", "mid_block.attentions.0")]


def convert_unet(sd: Dict, block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block: int = 2, ipa_state: Dict | None = None):
    """diffusers UNet2DConditionModel state dict -> flax params dict.

    ipa_state: the 'ip_adapter' dict of ip-adapter-faceid-plusv2_sd15.bin,
    numbered in attn_processors order (attn1, attn2 of each transformer:
    down, up, mid)."""
    n = len(block_out_channels)
    params = {
        "time_embedding": {
            "linear_1": _dense(sd, "time_embedding.linear_1"),
            "linear_2": _dense(sd, "time_embedding.linear_2"),
        },
        "conv_in": _conv(sd, "conv_in"),
        "conv_norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    for bi in range(n):
        for li in range(layers_per_block):
            params[f"down_{bi}_res_{li}"] = _resnet(
                sd, f"down_blocks.{bi}.resnets.{li}")
        if bi < n - 1:
            params[f"down_{bi}_downsample"] = {
                "conv": _conv(sd, f"down_blocks.{bi}.downsamplers.0.conv")}
    for bi in range(n):
        for li in range(layers_per_block + 1):
            params[f"up_{bi}_res_{li}"] = _resnet(
                sd, f"up_blocks.{bi}.resnets.{li}")
        if bi < n - 1:
            params[f"up_{bi}_upsample"] = {
                "conv": _conv(sd, f"up_blocks.{bi}.upsamplers.0.conv")}
    params["mid_res_0"] = _resnet(sd, "mid_block.resnets.0")
    params["mid_res_1"] = _resnet(sd, "mid_block.resnets.1")
    for i, (name, prefix) in enumerate(attention_prefixes(
            n, layers_per_block)):
        params[name] = _transformer2d(sd, prefix, ipa_state, str(2 * i),
                                      str(2 * i + 1))
    return {"params": params}


def _vae_attn(sd, p):
    return {
        "group_norm": _norm(sd, f"{p}.group_norm"),
        "to_q": _dense(sd, f"{p}.to_q"),
        "to_k": _dense(sd, f"{p}.to_k"),
        "to_v": _dense(sd, f"{p}.to_v"),
        "to_out": _dense(sd, f"{p}.to_out.0"),
    }


def convert_vae(sd: Dict, block_out_channels=(128, 256, 512, 512),
                layers_per_block: int = 2):
    n = len(block_out_channels)
    out = {}
    for part, lpb, kind in (("encoder", layers_per_block, "down"),
                            ("decoder", layers_per_block + 1, "up")):
        tree = {
            "conv_in": _conv(sd, f"{part}.conv_in"),
            "mid_res_0": _resnet(sd, f"{part}.mid_block.resnets.0"),
            "mid_attn": _vae_attn(sd, f"{part}.mid_block.attentions.0"),
            "mid_res_1": _resnet(sd, f"{part}.mid_block.resnets.1"),
            "conv_norm_out": _norm(sd, f"{part}.conv_norm_out"),
            "conv_out": _conv(sd, f"{part}.conv_out"),
        }
        sampler = "downsamplers" if kind == "down" else "upsamplers"
        for bi in range(n):
            for li in range(lpb):
                tree[f"{kind}_{bi}_res_{li}"] = _resnet(
                    sd, f"{part}.{kind}_blocks.{bi}.resnets.{li}")
            if bi < n - 1:
                tree[f"{kind}_{bi}_{kind}sample"] = _conv(
                    sd, f"{part}.{kind}_blocks.{bi}.{sampler}.0.conv")
        out[part] = tree
    out["quant_conv"] = _conv(sd, "quant_conv")
    out["post_quant_conv"] = _conv(sd, "post_quant_conv")
    return {"params": out}


def convert_controlnet(sd: Dict, block_out_channels=(320, 640, 1280, 1280),
                       layers_per_block: int = 2,
                       conditioning_embed_channels=(16, 32, 96, 256)):
    n = len(block_out_channels)
    n_cond_blocks = 2 * (len(conditioning_embed_channels) - 1)
    n_zero_convs = 1 + n * layers_per_block + (n - 1)
    params = {
        "time_embedding": {
            "linear_1": _dense(sd, "time_embedding.linear_1"),
            "linear_2": _dense(sd, "time_embedding.linear_2"),
        },
        "conv_in": _conv(sd, "conv_in"),
        "cond_conv_in": _conv(sd, "controlnet_cond_embedding.conv_in"),
        "cond_conv_out": _conv(sd, "controlnet_cond_embedding.conv_out"),
        "mid_res_0": _resnet(sd, "mid_block.resnets.0"),
        "mid_attn": _transformer2d(sd, "mid_block.attentions.0"),
        "mid_res_1": _resnet(sd, "mid_block.resnets.1"),
        "zero_conv_mid": _conv(sd, "controlnet_mid_block"),
    }
    for i in range(n_cond_blocks):
        params[f"cond_conv_{i}"] = _conv(
            sd, f"controlnet_cond_embedding.blocks.{i}")
    for bi in range(n):
        for li in range(layers_per_block):
            params[f"down_{bi}_res_{li}"] = _resnet(
                sd, f"down_blocks.{bi}.resnets.{li}")
            if bi < n - 1:
                params[f"down_{bi}_attn_{li}"] = _transformer2d(
                    sd, f"down_blocks.{bi}.attentions.{li}")
        if bi < n - 1:
            params[f"down_{bi}_downsample"] = {
                "conv": _conv(sd, f"down_blocks.{bi}.downsamplers.0.conv")}
    for i in range(n_zero_convs):
        params[f"zero_conv_{i}"] = _conv(sd, f"controlnet_down_blocks.{i}")
    return {"params": params}


def proj_plus_names(n_layers: int = 4):
    """(flax path, diffusers prefix, kind) of every ProjPlusModel leaf
    group; kind is "dense", "dense_nobias" or "norm"."""
    out = [(("proj_fc1",), "proj.0", "dense"),
           (("proj_fc2",), "proj.2", "dense"),
           (("norm",), "norm", "norm")]
    pr = "perceiver_resampler"
    out += [((pr, "proj_in"), f"{pr}.proj_in", "dense"),
            ((pr, "proj_out"), f"{pr}.proj_out", "dense"),
            ((pr, "norm_out"), f"{pr}.norm_out", "norm")]
    for i in range(n_layers):
        base = f"{pr}.layers.{i}"
        out += [((pr, f"attn_{i}", "norm1"), f"{base}.0.norm1", "norm"),
                ((pr, f"attn_{i}", "norm2"), f"{base}.0.norm2", "norm"),
                ((pr, f"attn_{i}", "to_q"), f"{base}.0.to_q", "dense_nobias"),
                ((pr, f"attn_{i}", "to_kv"), f"{base}.0.to_kv",
                 "dense_nobias"),
                ((pr, f"attn_{i}", "to_out"), f"{base}.0.to_out",
                 "dense_nobias"),
                ((pr, f"ff_{i}", "norm"), f"{base}.1.0", "norm"),
                ((pr, f"ff_{i}", "fc1"), f"{base}.1.1", "dense_nobias"),
                ((pr, f"ff_{i}", "fc2"), f"{base}.1.3", "dense_nobias")]
    return out


def convert_proj_plus(image_proj_sd: Dict):
    """'image_proj' dict of ip-adapter-faceid-plusv2_sd15.bin ->
    ProjPlusModel params."""
    p: Dict = {}
    for path, prefix, kind in proj_plus_names():
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (_norm(image_proj_sd, prefix) if kind == "norm"
                          else _dense(image_proj_sd, prefix,
                                      bias=kind == "dense"))
    return {"params": p}
