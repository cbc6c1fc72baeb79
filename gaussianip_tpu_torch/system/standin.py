"""Released-layout checkpoint sets written from port modules: the files
the real-weights path reads (system/pipeline.py's loaders), with the
released names, key layouts and dtypes, so that the loaders and
`python -m gaussianip_tpu_torch.launch` without --stub-guidance run where
the released checkpoints are not on disk. The tests write tiny sets,
chip_smoke.py one at the published widths; no user path calls this.
Here too are what only such sets need: the `.safetensors` writer, the
module -> flax tree walk (`flax_tree`, the inverse of
diffusion/from_flax.py) and the flax tree -> released state dict maps
(`export_*`, the inverses of diffusion/weights.py's converters).

Layout under `root` (the directories configs/exp.yaml names):
  Realistic_Vision_V4.0_noVAE/unet/diffusion_pytorch_model.safetensors
  Realistic_Vision_V4.0_noVAE/text_encoder/{config.json,model.safetensors}
  Realistic_Vision_V4.0_noVAE/tokenizer/{vocab.json,merges.txt,
      special_tokens_map.json,tokenizer_config.json}
  sd-vae-ft-mse/diffusion_pytorch_model.safetensors
  control_v11p_sd15_openpose/diffusion_pytorch_model.safetensors
  IP-Adapter/ip-adapter-faceid-plusv2_sd15.bin  (image_proj, ip_adapter)
  CLIP-ViT-H-14-laion2B-s32B-b79K/{config.json,model.safetensors}
  lpips/{vgg16.pth,vgg.pth}  (torchvision features.*, lpips lin*.model.1)
  assets/{face.png,irr_face.png}
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import asdict
from typing import Dict

import numpy as np
import torch

from ..diffusion import weights as W
from ..diffusion.lpips import VGG16_CONV_LAYERS
from ..guidance.tokenizer import BOS, EOS, basic_clean, bytes_to_unicode, \
    pretokenizer
from ..utils.saving import save_image

_ST_NAMES = {v: k for k, v in W.SAFETENSORS_DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Dict[str, str] | None = None):
    """Write {name: tensor} (CPU or device, any dtype of the format) as a
    .safetensors file: the tensors by element size, largest first, then by
    name, so that each one's offset is aligned to its element size; the
    header padded with spaces to a multiple of 8 bytes."""
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, offset = {}, 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header = {"__metadata__": dict(metadata), **header}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, t in items:
            t = t.detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return path


def flax_tree(module: nn.Module) -> dict:
    """A port module's parameters as a flax param tree {"params": ...} of
    float32 numpy arrays (the inverse of `flax_state_dict`): a 2-D or 4-D
    `weight` becomes `kernel`, a 1-D `weight` a norm's `scale`."""
    out: dict = {}
    for name, p in module.state_dict().items():
        *mods, leaf = name.split(".")
        a = p.detach().float().cpu().numpy()
        if leaf == "weight":
            if a.ndim in (2, 4):
                leaf = "kernel"
                a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
            else:
                leaf = "scale"
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return {"params": out}


def _inv_linear(k):
    return np.asarray(k).T


def _inv_conv(k):
    return np.asarray(k).transpose(3, 2, 0, 1)


def _emit_norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _emit_conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _inv_conv(p["kernel"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _emit_dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _inv_linear(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _emit_resnet(sd, prefix, p):
    _emit_norm(sd, f"{prefix}.norm1", p["norm1"])
    _emit_conv(sd, f"{prefix}.conv1", p["conv1"])
    _emit_norm(sd, f"{prefix}.norm2", p["norm2"])
    _emit_conv(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _emit_dense(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _emit_conv(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def _emit_attention(sd, prefix, p, lora_sd=None, lora_prefix=""):
    for name, tail in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                       ("to_out", "to_out.0")):
        # the UNet's projections are LoRADense nodes ({"main": ...}), the
        # ControlNet's too; the VAE's are plain Dense
        _emit_dense(sd, f"{prefix}.{tail}", p[name]["main"])
        if lora_sd is not None and "lora_down" in p[name]:
            lora_sd[f"{lora_prefix}.{name}_lora.down.weight"] = _inv_linear(
                p[name]["lora_down"]["kernel"])
            lora_sd[f"{lora_prefix}.{name}_lora.up.weight"] = _inv_linear(
                p[name]["lora_up"]["kernel"])
    if lora_sd is not None and "to_k_ip" in p:
        lora_sd[f"{lora_prefix}.to_k_ip.weight"] = _inv_linear(
            p["to_k_ip"]["kernel"])
        lora_sd[f"{lora_prefix}.to_v_ip.weight"] = _inv_linear(
            p["to_v_ip"]["kernel"])


def _emit_transformer2d(sd, prefix, p, lora_sd=None, i1="", i2=""):
    _emit_norm(sd, f"{prefix}.norm", p["norm"])
    _emit_conv(sd, f"{prefix}.proj_in", p["proj_in"])
    _emit_conv(sd, f"{prefix}.proj_out", p["proj_out"])
    tb = f"{prefix}.transformer_blocks.0"
    b = p["block_0"]
    _emit_norm(sd, f"{tb}.norm1", b["norm1"])
    _emit_attention(sd, f"{tb}.attn1", b["attn1"], lora_sd, i1)
    _emit_norm(sd, f"{tb}.norm2", b["norm2"])
    _emit_attention(sd, f"{tb}.attn2", b["attn2"], lora_sd, i2)
    _emit_norm(sd, f"{tb}.norm3", b["norm3"])
    _emit_dense(sd, f"{tb}.ff.net.0.proj", b["ff"]["geglu_proj"])
    _emit_dense(sd, f"{tb}.ff.net.2", b["ff"]["out_proj"])


def export_unet(params, block_out_channels=(320, 640, 1280, 1280),
                layers_per_block: int = 2):
    """flax UNet params -> (diffusers state dict, the IP-Adapter
    'ip_adapter' dict: LoRA and to_k_ip / to_v_ip)."""
    p = params["params"]
    n = len(block_out_channels)
    sd, lora = {}, {}
    _emit_dense(sd, "time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _emit_dense(sd, "time_embedding.linear_2", p["time_embedding"]["linear_2"])
    _emit_conv(sd, "conv_in", p["conv_in"])
    _emit_norm(sd, "conv_norm_out", p["conv_norm_out"])
    _emit_conv(sd, "conv_out", p["conv_out"])
    for bi in range(n):
        for li in range(layers_per_block):
            _emit_resnet(sd, f"down_blocks.{bi}.resnets.{li}",
                         p[f"down_{bi}_res_{li}"])
        if bi < n - 1:
            _emit_conv(sd, f"down_blocks.{bi}.downsamplers.0.conv",
                       p[f"down_{bi}_downsample"]["conv"])
    for bi in range(n):
        for li in range(layers_per_block + 1):
            _emit_resnet(sd, f"up_blocks.{bi}.resnets.{li}",
                         p[f"up_{bi}_res_{li}"])
        if bi < n - 1:
            _emit_conv(sd, f"up_blocks.{bi}.upsamplers.0.conv",
                       p[f"up_{bi}_upsample"]["conv"])
    _emit_resnet(sd, "mid_block.resnets.0", p["mid_res_0"])
    _emit_resnet(sd, "mid_block.resnets.1", p["mid_res_1"])
    for i, (name, prefix) in enumerate(W.attention_prefixes(
            n, layers_per_block)):
        _emit_transformer2d(sd, prefix, p[name], lora, str(2 * i),
                            str(2 * i + 1))
    return sd, lora


def export_vae(params, block_out_channels=(128, 256, 512, 512),
               layers_per_block: int = 2):
    p = params["params"]
    n = len(block_out_channels)
    sd = {}
    for part, lpb, kind in (("encoder", layers_per_block, "down"),
                            ("decoder", layers_per_block + 1, "up")):
        q = p[part]
        _emit_conv(sd, f"{part}.conv_in", q["conv_in"])
        _emit_resnet(sd, f"{part}.mid_block.resnets.0", q["mid_res_0"])
        attn = f"{part}.mid_block.attentions.0"
        _emit_norm(sd, f"{attn}.group_norm", q["mid_attn"]["group_norm"])
        for name, tail in (("to_q", "to_q"), ("to_k", "to_k"),
                           ("to_v", "to_v"), ("to_out", "to_out.0")):
            _emit_dense(sd, f"{attn}.{tail}", q["mid_attn"][name])
        _emit_resnet(sd, f"{part}.mid_block.resnets.1", q["mid_res_1"])
        _emit_norm(sd, f"{part}.conv_norm_out", q["conv_norm_out"])
        _emit_conv(sd, f"{part}.conv_out", q["conv_out"])
        sampler = "downsamplers" if kind == "down" else "upsamplers"
        for bi in range(n):
            for li in range(lpb):
                _emit_resnet(sd, f"{part}.{kind}_blocks.{bi}.resnets.{li}",
                             q[f"{kind}_{bi}_res_{li}"])
            if bi < n - 1:
                _emit_conv(sd, f"{part}.{kind}_blocks.{bi}.{sampler}.0.conv",
                           q[f"{kind}_{bi}_{kind}sample"])
    _emit_conv(sd, "quant_conv", p["quant_conv"])
    _emit_conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def export_controlnet(params, block_out_channels=(320, 640, 1280, 1280),
                      layers_per_block: int = 2,
                      conditioning_embed_channels=(16, 32, 96, 256)):
    """flax ControlNet params -> diffusers ControlNetModel state dict (the
    inverse of convert_controlnet)."""
    p = params["params"]
    n = len(block_out_channels)
    sd = {}
    _emit_dense(sd, "time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _emit_dense(sd, "time_embedding.linear_2", p["time_embedding"]["linear_2"])
    _emit_conv(sd, "conv_in", p["conv_in"])
    _emit_conv(sd, "controlnet_cond_embedding.conv_in", p["cond_conv_in"])
    _emit_conv(sd, "controlnet_cond_embedding.conv_out", p["cond_conv_out"])
    for i in range(2 * (len(conditioning_embed_channels) - 1)):
        _emit_conv(sd, f"controlnet_cond_embedding.blocks.{i}",
                   p[f"cond_conv_{i}"])
    for bi in range(n):
        for li in range(layers_per_block):
            _emit_resnet(sd, f"down_blocks.{bi}.resnets.{li}",
                         p[f"down_{bi}_res_{li}"])
            if bi < n - 1:
                _emit_transformer2d(sd, f"down_blocks.{bi}.attentions.{li}",
                                    p[f"down_{bi}_attn_{li}"])
        if bi < n - 1:
            _emit_conv(sd, f"down_blocks.{bi}.downsamplers.0.conv",
                       p[f"down_{bi}_downsample"]["conv"])
    _emit_resnet(sd, "mid_block.resnets.0", p["mid_res_0"])
    _emit_transformer2d(sd, "mid_block.attentions.0", p["mid_attn"])
    _emit_resnet(sd, "mid_block.resnets.1", p["mid_res_1"])
    _emit_conv(sd, "controlnet_mid_block", p["zero_conv_mid"])
    for i in range(1 + n * layers_per_block + (n - 1)):
        _emit_conv(sd, f"controlnet_down_blocks.{i}", p[f"zero_conv_{i}"])
    return sd


def export_proj_plus(params):
    """flax ProjPlusModel params -> the IP-Adapter 'image_proj' dict (the
    inverse of convert_proj_plus)."""
    p = params["params"]
    sd = {}
    for path, prefix, kind in W.proj_plus_names():
        node = p
        for k in path:
            node = node[k]
        (_emit_norm if kind == "norm" else _emit_dense)(sd, prefix, node)
    return sd


def export_ip_adapter(unet_params, proj_params,
                      block_out_channels=(320, 640, 1280, 1280),
                      layers_per_block: int = 2):
    """-> the ip-adapter-faceid-plusv2_sd15.bin dict {"image_proj": ...,
    "ip_adapter": ...} of numpy arrays, from a UNet tree with LoRA and IP
    projections and a ProjPlusModel tree."""
    _, lora = export_unet(unet_params, block_out_channels, layers_per_block)
    return {"image_proj": export_proj_plus(proj_params), "ip_adapter": lora}


def handmade_bpe(texts) -> tuple:
    """(vocab, merges) of a byte-level BPE that has every byte symbol, alone
    and word-final, and merges that build each word of `texts` left to
    right (a stand-in for CLIP's 49,408-entry files)."""
    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    merges = []
    enc = bytes_to_unicode()
    for text in texts:
        for tok in pretokenizer().findall(basic_clean(text)):
            chars = [enc[b] for b in tok.encode("utf-8")]
            chars[-1] += "</w>"
            cur = chars[0]
            for c in chars[1:]:
                if cur + c not in vocab:
                    merges.append(f"{cur} {c}")
                    vocab[cur + c] = len(vocab)
                cur += c
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return vocab, merges


# each file's dtype, as the released files store them (the ViT-H's
# float16 safetensors; the SD text encoder and LPIPS in float32)
FILE_DTYPES = {"unet": torch.float16, "controlnet": torch.float16,
               "vae": torch.float32, "ip_adapter": torch.float16,
               "text_encoder": torch.float32,
               "image_encoder": torch.float16}


def _write_json(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def _tensors(sd: dict, dtype) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dtype)
            for k, v in sd.items()}


def _cond_channels(controlnet) -> tuple:
    return tuple([controlnet.cond_conv_in.weight.shape[0]] + [
        getattr(controlnet, f"cond_conv_{2 * i + 1}").weight.shape[0]
        for i in range(controlnet.n_cond)])


def write_checkpoint_set(root: str, *, unet, controlnet, vae, proj,
                         text_encoder, vision_encoder, lpips, texts,
                         faces) -> dict:
    """Write the set from port modules: `unet` with its IP-Adapter LoRA and
    IP projections (lora_rank > 0, ip_tokens > 0), `controlnet`, `vae`,
    `proj` (ProjPlusModel), `text_encoder` (diffusion/clip.CLIPTextModel),
    `vision_encoder` (CLIPVisionModel), `lpips` (diffusion/lpips.LPIPS at
    VGG16's layout), the tokenizer's words from `texts`, and `faces` (two
    [H, W, 3] images in [0, 1]). Each file in its FILE_DTYPES dtype, the
    LPIPS checkpoints in float32.
    -> {"overrides": the dotted config overrides that point the recipe
    at the set, "files": {name: path}}."""
    base = os.path.join(root, "Realistic_Vision_V4.0_noVAE")
    files = {
        "unet": os.path.join(base, "unet",
                             "diffusion_pytorch_model.safetensors"),
        "vae": os.path.join(root, "sd-vae-ft-mse",
                            "diffusion_pytorch_model.safetensors"),
        "controlnet": os.path.join(root, "control_v11p_sd15_openpose",
                                   "diffusion_pytorch_model.safetensors"),
        "ip_adapter": os.path.join(root, "IP-Adapter",
                                   "ip-adapter-faceid-plusv2_sd15.bin"),
        "text_encoder": os.path.join(base, "text_encoder",
                                     "model.safetensors"),
        "image_encoder": os.path.join(root, "CLIP-ViT-H-14-laion2B-s32B-b79K",
                                      "model.safetensors"),
        "lpips_vgg": os.path.join(root, "lpips", "vgg16.pth"),
        "lpips_lin": os.path.join(root, "lpips", "vgg.pth"),
        "face": os.path.join(root, "assets", "face.png"),
        "irr_face": os.path.join(root, "assets", "irr_face.png"),
    }
    for p in files.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)
    tok_dir = os.path.join(base, "tokenizer")
    os.makedirs(tok_dir, exist_ok=True)

    ucfg = unet.cfg
    utree = flax_tree(unet)
    sd, lora = export_unet(utree, ucfg.block_out_channels,
                             ucfg.layers_per_block)
    dt = FILE_DTYPES
    write_safetensors(files["unet"], _tensors(sd, dt["unet"]))
    ipa = export_ip_adapter(utree, flax_tree(proj),
                              ucfg.block_out_channels,
                              ucfg.layers_per_block)
    torch.save({k: _tensors(v, dt["ip_adapter"]) for k, v in ipa.items()},
               files["ip_adapter"])
    del sd, lora, ipa, utree
    vcfg = vae.cfg
    write_safetensors(files["vae"], _tensors(export_vae(
        flax_tree(vae), vcfg.block_out_channels, vcfg.layers_per_block),
        dt["vae"]))
    ccfg = controlnet.cfg
    write_safetensors(files["controlnet"], _tensors(export_controlnet(
        flax_tree(controlnet), ccfg.block_out_channels,
        ccfg.layers_per_block, _cond_channels(controlnet)),
        dt["controlnet"]))

    write_safetensors(files["text_encoder"], {
        k: v.to(dt["text_encoder"])
        for k, v in text_encoder.state_dict().items()})
    _write_json(os.path.join(base, "text_encoder", "config.json"), {
        "architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
        **asdict(text_encoder.cfg)})
    vocab, merges = handmade_bpe(texts)
    _write_json(os.path.join(tok_dir, "vocab.json"), vocab)
    with open(os.path.join(tok_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(m + "\n" for m in merges))
    special = {"bos_token": BOS, "eos_token": EOS, "pad_token": EOS,
               "unk_token": EOS}
    _write_json(os.path.join(tok_dir, "special_tokens_map.json"), special)
    _write_json(os.path.join(tok_dir, "tokenizer_config.json"),
                {**special, "model_max_length": 77,
                 "tokenizer_class": "CLIPTokenizer"})

    # a full CLIPModel checkpoint: the vision tower, its projection and the
    # logit scale (the loader reads vision_model.* only)
    vd = vision_encoder.cfg.hidden_size
    gen = torch.Generator().manual_seed(0)
    vdt = dt["image_encoder"]
    vis = {k: v.to(vdt) for k, v in vision_encoder.state_dict().items()}
    vis["visual_projection.weight"] = (torch.randn(
        (1024, vd), generator=gen) / vd ** 0.5).to(vdt)
    vis["logit_scale"] = torch.tensor(2.6592, dtype=vdt)
    write_safetensors(files["image_encoder"], vis)
    _write_json(os.path.join(os.path.dirname(files["image_encoder"]),
                             "config.json"),
                {"architectures": ["CLIPModel"], "model_type": "clip",
                 "projection_dim": 1024,
                 "vision_config": asdict(vision_encoder.cfg)})

    lp = lpips.state_dict()
    torch.save({k: v for ci, tl in enumerate(VGG16_CONV_LAYERS)
                for k, v in ((f"features.{tl}.weight",
                              lp[f"vgg.conv_{ci}.weight"].cpu()),
                             (f"features.{tl}.bias",
                              lp[f"vgg.conv_{ci}.bias"].cpu()))},
               files["lpips_vgg"])
    torch.save({f"lin{i}.model.1.weight":
                lp[f"lin_{i}"].cpu().reshape(1, -1, 1, 1)
                for i in range(len(lpips.vgg.stages))},
               files["lpips_lin"])
    save_image(files["face"], faces[0])
    save_image(files["irr_face"], faces[1])

    g = "system.guidance."
    overrides = [
        f"{g}pretrained_realistic_model_name_or_path={base}",
        f"{g}vae_path={os.path.dirname(files['vae'])}",
        f"{g}pose_controlnet_path={os.path.dirname(files['controlnet'])}",
        f"{g}ip_ckpt_faceid_v2_path={files['ip_adapter']}",
        f"{g}image_encoder_faceid_path="
        f"{os.path.dirname(files['image_encoder'])}",
        f"{g}pil_image_faceid_path={files['face']}",
        f"{g}irr_pil_image_path={files['irr_face']}",
        f"system.lpips_vgg_path={files['lpips_vgg']}",
        f"system.lpips_lin_path={files['lpips_lin']}",
    ]
    return {"overrides": overrides, "files": files}


def random_faces(seed: int, size: int = 256) -> list:
    """Two smooth random [size, size, 3] images in [0, 1]: low-frequency
    colour fields from `seed`."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(2):
        f = rng.uniform(1, 4, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, (3, 2))
        img = np.stack([0.5 + 0.25 * (np.sin(2 * np.pi * f[c, 0] * x
                                             + ph[c, 0])
                                      + np.sin(2 * np.pi * f[c, 1] * y
                                               + ph[c, 1]))
                        for c in range(3)], -1)
        out.append(img.astype(np.float32))
    return out
