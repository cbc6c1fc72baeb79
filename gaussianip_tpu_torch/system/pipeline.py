"""Assembly of the diffusion guidance stack (port of
gaussianip_tpu/system/pipeline.py).

  * The real-weights loaders: `load_real_models` (the SD1.5 UNet with the
    IP-Adapter LoRA folded in, the OpenPose ControlNet and the VAE from
    diffusers-layout checkpoints), `load_ip_adapter_proj` (ProjPlusModel),
    `load_text_encoder` (CLIP-L tokenizer and text transformer),
    `load_image_encoder` (CLIP-ViT-H/14, penultimate hidden states),
    `face_identity` (insightface, or the JAX package's loudly warned
    fallback) and `load_lpips` (VGG16 + the LPIPS heads, or None and L1
    alone). Each builds on the CPU and moves to the caller's device.
  * `build_random_sd15_guidance`: the recipe's stack at its full published
    widths (SD1.5 UNet with IP-Adapter tokens, OpenPose ControlNet, SD VAE,
    IP-Adapter-FaceID-Plus ProjPlusModel, 77 x 768 text embeddings) with
    seeded random float32 weights computed at bf16, and the guidance
    settings of configs/exp.yaml.
  * `build_random_sdxl_guidance`: the same at SDXL base 1.0's widths
    (`sdxl_unet_config`; an SDXL OpenPose ControlNet; FaceID PlusV2 SDXL's
    4 identity tokens at 2048; the SD VAE at SDXL's scaling factor; 77 x
    2048 text and 1280 pooled embeddings), guiding at 1024^2.
  * `build_random_flux_guidance`: FLUX.1-dev's velocity prior
    (`flux_config`: the transformer with IP identity attention, the Union
    ControlNet in OpenPose mode, the 16-channel VAE), its weights held at
    bf16, 512 x 4096 T5 and 768 pooled embeddings and 4 identity tokens
    at 4096, guiding at 1024^2.
  * `build_stub_guidance_stack`: the tiny weight-free stack for smoke runs.
  * Stage 2 runs the same UNet, ControlNet and VAE (`refine_models`), with
    identity tokens at s_scale 0.5 (`random_refine_contexts`); stage 3's
    LPIPS at VGG16 width with random weights is `build_random_lpips`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn

import gaussianip_tpu_torch as gt

from ..diffusion import weights as W
from ..diffusion.from_flax import flax_state_dict
from ..diffusion.flux import FluxConfig, FluxControlNet, FluxTransformer
from ..diffusion.ip_adapter import ProjPlusModel
from ..diffusion.lpips import LPIPS, VGG16_STAGES, convert_lpips_weights
from ..diffusion.unet import (
    ControlNetModel,
    UNet2DConditionModel,
    UNetConfig,
    tiny_unet_config,
)
from ..diffusion.vae import (FLUX_VAE_SCALING, FLUX_VAE_SHIFT,
                             SDXL_VAE_SCALING, AutoencoderKL, VAEConfig,
                             tiny_vae_config)
from ..guidance.ipa import (
    AHDSGuidance,
    GuidanceConfig,
    GuidanceModels,
    ImageEmbeds,
    compute_image_embeds,
)
from ..guidance.prompts import (PromptEmbeddings, fake_text_encoder,
                               make_prompt_embeddings)
from .refine import RefineModels, refine_contexts, refine_identity_tokens

# configs/exp.yaml system.prompt_processor.prompt and
# system.guidance.negative_prompt_faceid
RECIPE_PROMPT = ("Audrey Hepburn wearing a tailored blazer, a shirt "
                 "underneath, straight-cut trousers, and low-heeled shoes.")
RECIPE_NEGATIVE_PROMPT = (
    "cloned face, multi face, bad face, poorly drawn face, duplicate face, "
    "cropped, out of frame, extra fingers, deformed, blurry, bad "
    "proportions, disfigured, fused fingers, long neck")
# the ControlNet's zero-initialised output convs get this fraction of the
# lecun scale, so that its residuals are small but not identically zero
ZERO_CONV_SCALE = 0.1


def sd15_unet_config(lora_rank: int = 0, ip_tokens: int = 4,
                     dtype=torch.bfloat16) -> UNetConfig:
    """SD1.5 widths (320/640/1280/1280). lora_rank 0 is the UNet after the
    IP-Adapter LoRA is folded into the base weights."""
    return UNetConfig(lora_rank=lora_rank, ip_tokens=ip_tokens, dtype=dtype)


def sdxl_unet_config(lora_rank: int = 0, ip_tokens: int = 4,
                     dtype=torch.bfloat16) -> UNetConfig:
    """SDXL base 1.0's UNet (unet/config.json): levels 320/640/1280, the
    first without attention, 2 and 10 transformer blocks on the others
    and 10 in the mid block, 64-wide heads, linear projections, 2048-wide
    cross-attention and the text-time added embedding (6 ids at 256 after
    the 1280 pooled text). lora_rank 0: the IP-Adapter LoRA folded in."""
    return UNetConfig(block_out_channels=(320, 640, 1280),
                      cross_attention_dim=2048,
                      attention_head_dim=(5, 10, 20),
                      transformer_layers_per_block=(0, 2, 10),
                      use_linear_projection=True,
                      addition_time_embed_dim=256,
                      projection_class_embeddings_input_dim=2816,
                      lora_rank=lora_rank, ip_tokens=ip_tokens, dtype=dtype)


def flux_config(num_layers: int = 19, num_single_layers: int = 38,
                ip_tokens: int = 4, dtype=torch.bfloat16) -> FluxConfig:
    """FLUX.1-dev's transformer (transformer/config.json: 24 heads of 128,
    T5-XXL's 4096-wide tokens, CLIP-L's 768-wide pooled vector, RoPE axes
    16 / 56 / 56, the embedded guidance) with `ip_tokens` identity tokens
    at 4096 (XLabs' flux-ip-adapter); its Union ControlNet is
    flux_config(5, 10, 0). Parameters are held at `dtype`."""
    return FluxConfig(num_layers=num_layers,
                      num_single_layers=num_single_layers,
                      ip_tokens=ip_tokens, dtype=dtype)


def flux_vae_config(dtype=torch.bfloat16) -> VAEConfig:
    """FLUX.1-dev's VAE (vae/config.json): the SD VAE's widths, 16 latent
    channels, no quant convs, (z - 0.1159) * 0.3611."""
    return VAEConfig(latent_channels=16, scaling_factor=FLUX_VAE_SCALING,
                     shift_factor=FLUX_VAE_SHIFT, quant_convs=False,
                     dtype=dtype)


def init_random_(module: nn.Module, generator: torch.Generator,
                 kernel_std: float | None = None) -> nn.Module:
    """Seeded random parameters, in place: flax's default initialisers
    (lecun-normal kernels, zero biases, unit norm scales) or, with
    `kernel_std`, N(0, kernel_std) kernels. `generator` lives on the
    parameters' device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "latents":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]),
                          generator=generator)
            elif p.dim() >= 2:
                std = kernel_std or 1.0 / math.sqrt(p[0].numel())
                p.normal_(0.0, std, generator=generator)
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
    return module


def _build(ctor, generator, device, kernel_std=None):
    with torch.device("meta"):
        m = ctor()
    m = m.to_empty(device=device)
    return init_random_(m, generator, kernel_std)


def _scale_zero_convs_(cn: ControlNetModel):
    with torch.no_grad():
        for name, p in cn.named_parameters():
            if name.startswith(("zero_conv_", "cond_conv_out.")) \
                    and name.endswith("weight"):
                p.mul_(ZERO_CONV_SCALE)


def load_flax_tree(ctor, params, device) -> nn.Module:
    """`ctor()` built on the meta device with a flax param tree's arrays
    as its parameters (what `from_flax` loads, without a first
    initialisation), then moved to `device`."""
    with torch.device("meta"):
        m = ctor()
    m.load_state_dict(flax_state_dict(params), strict=True, assign=True)
    return m.to(device)


def _find_sd(base: str, *names: str):
    for n in names:
        for ext in (".safetensors", ".bin"):
            p = os.path.join(base, n + ext)
            if os.path.exists(p):
                return W.load_torch_state_dict(p, keep_dtype=True)
    raise FileNotFoundError(
        f"no checkpoint under {base} (tried {names}); run with "
        f"--stub-guidance for a weight-free smoke run")


def load_real_models(cfg_guidance: dict, dtype=torch.bfloat16,
                     device="cuda") -> GuidanceModels:
    """The UNet, ControlNet and VAE from the configured checkpoint paths
    (diffusers layout: <pretrained_realistic_model_name_or_path>/unet/,
    <vae_path>/, <pose_controlnet_path>/, each
    diffusion_pytorch_model.safetensors or .bin). Raises FileNotFoundError
    when one is absent. The IP-Adapter's LoRA (`ip_ckpt_faceid_v2_path`,
    when it exists) runs at a static scale, so it is folded into the base
    kernels here and the UNet has lora_rank 0. Parameters are float32,
    compute is `dtype`."""
    ucfg = sd15_unet_config(lora_rank=0, dtype=dtype)
    base = cfg_guidance["pretrained_realistic_model_name_or_path"]
    usd = _find_sd(os.path.join(base, "unet"), "diffusion_pytorch_model")
    ipa_sd = None
    ipa_path = cfg_guidance.get("ip_ckpt_faceid_v2_path", "")
    if ipa_path and os.path.exists(ipa_path):
        ipa_sd = W.load_torch_state_dict(ipa_path).get("ip_adapter")
    unet = load_flax_tree(
        lambda: UNet2DConditionModel(ucfg), W.fold_lora(W.convert_unet(
            usd, ucfg.block_out_channels, ucfg.layers_per_block,
            ipa_state=ipa_sd)), device)
    del usd
    vcfg = VAEConfig(dtype=dtype)
    vsd = _find_sd(cfg_guidance["vae_path"], "diffusion_pytorch_model")
    vae = load_flax_tree(lambda: AutoencoderKL(vcfg), W.convert_vae(
        vsd, vcfg.block_out_channels, vcfg.layers_per_block), device)
    ccfg = sd15_unet_config(lora_rank=0, ip_tokens=0, dtype=dtype)
    csd = _find_sd(cfg_guidance["pose_controlnet_path"],
                   "diffusion_pytorch_model")
    cn = load_flax_tree(lambda: ControlNetModel(ccfg), W.convert_controlnet(
        csd, ccfg.block_out_channels, ccfg.layers_per_block), device)
    return GuidanceModels(unet, cn, vae)


def load_ip_adapter_proj(path: str, device="cuda") -> ProjPlusModel:
    """The ProjPlusModel of ip-adapter-faceid-plusv2_sd15.bin's
    `image_proj` dict, in float32 as the JAX package runs it."""
    proj = W.load_torch_state_dict(path)["image_proj"]
    return load_flax_tree(ProjPlusModel, W.convert_proj_plus(proj), device)


def load_text_encoder(model_path: str, device="cuda"):
    """The SD checkpoint's CLIP tokenizer (<model_path>/tokenizer/) and
    text transformer (<model_path>/text_encoder/). Returns encode(list of
    prompts) -> numpy [N, 77, D] float32 (the last hidden state)."""
    from ..diffusion.clip import load_clip_text
    from ..guidance.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(os.path.join(model_path,
                                                     "tokenizer"))
    enc = load_clip_text(os.path.join(model_path, "text_encoder"), device)

    @torch.no_grad()
    def encode(prompts):
        ids = torch.as_tensor(tok(prompts, max_length=77), device=device)
        return enc(ids).float().cpu().numpy()

    return encode


# CLIP's image normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_image_encoder(model_path: str, device="cuda"):
    """The CLIP-ViT-H/14 vision tower. Returns encode_hidden(images
    [N, 224, 224, 3] in [0, 1], numpy or tensor) -> the penultimate hidden
    states [N, 257, 1280] float32 on `device`."""
    from ..diffusion.clip import load_clip_vision

    enc = load_clip_vision(model_path, device)
    mean = torch.tensor(CLIP_MEAN, device=device)
    std = torch.tensor(CLIP_STD, device=device)

    @torch.no_grad()
    def encode_hidden(images):
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        return enc(((x - mean) / std).permute(0, 3, 1, 2).contiguous())

    return encode_hidden


def face_identity(image_path: str, irr_image_path: str):
    """Face detection, ArcFace embedding and the aligned 224^2 crop of the
    face photo and the irrelevant face, through insightface (buffalo_l).
    -> ((embedding [1, 512], crop [1, 224, 224, 3] in [0, 1]), (the same
    for the irrelevant face)), numpy float32.

    Without insightface (or when it fails) the JAX package's fallback, with
    the same loud warning: a centre crop resized to 224^2 by PIL and a
    random unit embedding seeded by the path and the image's float32 mean
    (numpy's, on the same array). Python salts the hash of a str per
    process, so the fallback's embedding is the same only within one
    process, as in the JAX package (launch gives every data-parallel rank
    rank 0's). The PNGs are read by utils/saving.py;
    PIL is needed for the resize alone."""
    try:
        import cv2
        from insightface.app import FaceAnalysis
        from insightface.utils import face_align

        app = FaceAnalysis(name="buffalo_l",
                           providers=["CPUExecutionProvider"])
        app.prepare(ctx_id=0, det_size=(640, 640))

        def embed(p):
            img = cv2.imread(p)
            faces = app.get(img)
            e = faces[0].normed_embedding
            crop = face_align.norm_crop(img, landmark=faces[0].kps,
                                        image_size=224)
            return np.asarray(e, np.float32)[None], (
                crop[..., ::-1].astype(np.float32) / 255.0)[None]

        return embed(image_path), embed(irr_image_path)
    except Exception:
        gt.warn("insightface unavailable — using fallback face identity "
                "(center crop + image-hash embedding); identity preservation "
                "quality will be reduced")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "face_identity's fallback resizes the face crop with PIL "
            "(Image.resize), which is not installed; install Pillow or "
            "insightface") from e
    from ..utils.saving import read_png

    def embed(p):
        img = read_png(p).astype(np.float32) / 255.0
        h, w = img.shape[:2]
        s = min(h, w)
        crop = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
        crop224 = np.asarray(
            Image.fromarray((crop * 255).astype(np.uint8)).resize((224, 224)),
            np.float32) / 255.0
        rng = np.random.default_rng(
            abs(hash(p + str(float(img.mean())))) % (2 ** 31))
        e = rng.normal(size=(512,)).astype(np.float32)
        e /= np.linalg.norm(e)
        return e[None], crop224[None]

    return embed(image_path), embed(irr_image_path)


def load_lpips(sys_cfg: dict, device="cuda"):
    """Stage 3's perceptual loss: the torchvision VGG16 and LPIPS
    linear-head checkpoints at `lpips_vgg_path` / `lpips_lin_path` -> the
    frozen float32 LPIPS module ((x, y) -> [B] distances), or None with a
    loud warning when either is not configured or absent: stage 3 then
    trains on L1 alone, which the reference never does."""
    vgg_path = sys_cfg.get("lpips_vgg_path", "")
    lin_path = sys_cfg.get("lpips_lin_path", "")
    if not (vgg_path and lin_path and os.path.exists(vgg_path)
            and os.path.exists(lin_path)):
        gt.warn(
            "=" * 70 + "\nLPIPS weights not found (system.lpips_vgg_path / "
            "system.lpips_lin_path): stage 3 will train with L1 ONLY. The "
            "reference optimizes 10*L1 + 15*LPIPS (GaussianIP.py:432-436) — "
            "supply the torchvision vgg16 and lpips vgg linear checkpoints "
            "for quality parity.\n" + "=" * 70)
        return None
    sd = convert_lpips_weights(W.load_torch_state_dict(vgg_path),
                               W.load_torch_state_dict(lin_path))
    with torch.device("meta"):
        m = LPIPS(VGG16_STAGES)
    m.load_state_dict(sd, strict=True, assign=True)
    return m.to(device).requires_grad_(False)


def _random_faces(gen: torch.Generator, device, width: int = 768):
    """A random ProjPlusModel (bf16) to `width`-wide identity tokens, two
    random unit ArcFace vectors [2, 512] (the positive and the irrelevant
    face) and three random CLIP hidden states [3, 1, 257, 1280] (positive,
    irrelevant, zero image)."""
    proj = _build(lambda: ProjPlusModel(width, dtype=torch.bfloat16), gen,
                  device)
    ids = torch.randn((2, 512), generator=gen, device=device)
    ids = ids / torch.linalg.vector_norm(ids, dim=-1, keepdim=True)
    clip = torch.randn((3, 1, 257, 1280), generator=gen, device=device)
    return proj, ids, clip


def build_random_sd15_guidance(seed: int = 0,
                               device="cuda") -> AHDSGuidance:
    """The recipe's guidance stack at full width with random weights from
    `seed`, computed at bf16: UNet (ip_tokens 4, LoRA folded), ControlNet
    (ip_tokens 0), VAE (128/256/512/512), ProjPlusModel (s_scale 0.4) on a
    random unit ArcFace vector and random CLIP hidden states, fake
    77 x 768 text embeddings of the recipe's prompts, GuidanceConfig of
    configs/exp.yaml."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16
    unet = _build(lambda: UNet2DConditionModel(
        sd15_unet_config(0, 4, dtype)), gen, device)
    cn = _build(lambda: ControlNetModel(sd15_unet_config(0, 0, dtype)), gen,
                device)
    _scale_zero_convs_(cn)
    vae = _build(lambda: AutoencoderKL(VAEConfig(dtype=dtype)), gen, device)
    proj, ids, clip = _random_faces(gen, device)
    img = compute_image_embeds(proj, ids[:1], ids[1:], clip[0], clip[1],
                               clip[2], s_scale=0.4)
    pe = make_prompt_embeddings(fake_text_encoder(77, 768), RECIPE_PROMPT,
                                RECIPE_NEGATIVE_PROMPT, "", device=device)
    gcfg = GuidanceConfig(guidance_scale=7.5, guidance_rescale=0.75,
                          ipa_scale=0.5, use_anpg=True,
                          use_pose_controlnet=True,
                          view_dependent_prompting=True,
                          grad_clip_pixel=True, grad_clip_threshold=1.0,
                          image_size=512)
    return AHDSGuidance(GuidanceModels(unet, cn, vae), pe, img, gcfg)


def build_random_sdxl_guidance(seed: int = 0,
                               device="cuda") -> AHDSGuidance:
    """The SDXL guidance stack at full width with random weights from
    `seed`, computed at bf16: UNet (`sdxl_unet_config`, ip_tokens 4, LoRA
    folded), ControlNet (ip_tokens 0), VAE (128/256/512/512, scaling
    0.13025), a 2048-wide ProjPlusModel (s_scale 0.4) on a random unit
    ArcFace vector and random CLIP hidden states, fake 77 x 2048 text and
    1280 pooled embeddings of the recipe's prompts, GuidanceConfig of
    configs/exp.yaml at image_size 1024."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16
    unet = _build(lambda: UNet2DConditionModel(
        sdxl_unet_config(0, 4, dtype)), gen, device)
    cn = _build(lambda: ControlNetModel(sdxl_unet_config(0, 0, dtype)), gen,
                device)
    _scale_zero_convs_(cn)
    vae = _build(lambda: AutoencoderKL(VAEConfig(
        scaling_factor=SDXL_VAE_SCALING, dtype=dtype)), gen, device)
    proj, ids, clip = _random_faces(gen, device, 2048)
    img = compute_image_embeds(proj, ids[:1], ids[1:], clip[0], clip[1],
                               clip[2], s_scale=0.4)
    prompts = (RECIPE_PROMPT, RECIPE_NEGATIVE_PROMPT, "")
    pe = make_prompt_embeddings(fake_text_encoder(77, 2048), *prompts,
                                device=device)
    p = make_prompt_embeddings(fake_text_encoder(1, 1280), *prompts,
                               device=device)
    pe = pe._replace(pooled=PromptEmbeddings(
        p.text_vd[:, 0], p.uncond_vd[:, 0], p.null[0], p.text[0]))
    gcfg = GuidanceConfig(guidance_scale=7.5, guidance_rescale=0.75,
                          ipa_scale=0.5, use_anpg=True,
                          use_pose_controlnet=True,
                          view_dependent_prompting=True,
                          grad_clip_pixel=True, grad_clip_threshold=1.0,
                          image_size=1024)
    return AHDSGuidance(GuidanceModels(unet, cn, vae), pe, img, gcfg)


def build_random_flux_guidance(seed: int = 0,
                               device="cuda") -> AHDSGuidance:
    """The FLUX.1-dev guidance stack at full width with random weights
    from `seed`, held and computed at bf16 (the VAE: float32 masters):
    the transformer (`flux_config`, 4 identity tokens), the Union
    ControlNet (5 + 10 blocks, OpenPose mode; its zero-initialised
    Linears at ZERO_CONV_SCALE), the 16-channel VAE, fake 512 x 4096 T5
    and 768 pooled embeddings of the recipe's prompts, N(0, 1) identity
    tokens [1, 4, 4096] in place of XLabs' ImageProjModel's, and
    GuidanceConfig of configs/exp.yaml at image_size 1024 with g 3.5; a
    velocity prior."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16
    flux = _build(lambda: FluxTransformer(flux_config(dtype=dtype)), gen,
                  device)
    cn = _build(lambda: FluxControlNet(flux_config(5, 10, 0, dtype)), gen,
                device)
    with torch.no_grad():
        for name, p in cn.named_parameters():
            if name.startswith(("controlnet_blocks.",
                                "controlnet_single_blocks.",
                                "controlnet_x_embedder.")):
                p.mul_(ZERO_CONV_SCALE)
    vae = _build(lambda: AutoencoderKL(flux_vae_config(dtype)), gen, device)
    prompts = (RECIPE_PROMPT, RECIPE_NEGATIVE_PROMPT, "")
    pe = make_prompt_embeddings(fake_text_encoder(512, 4096), *prompts,
                                device=device)
    p = make_prompt_embeddings(fake_text_encoder(1, 768), *prompts,
                               device=device)
    pe = pe._replace(pooled=PromptEmbeddings(
        p.text_vd[:, 0], p.uncond_vd[:, 0], p.null[0], p.text[0]))
    ids = torch.randn((3, 1, 4, 4096), generator=gen, device=device)
    img = ImageEmbeds(pos=ids[0], null=ids[1], neg=ids[2])
    gcfg = GuidanceConfig(guidance_scale=7.5, guidance_rescale=0.75,
                          ipa_scale=0.5, use_anpg=True,
                          use_pose_controlnet=True,
                          view_dependent_prompting=True,
                          grad_clip_pixel=True, grad_clip_threshold=1.0,
                          image_size=1024)
    return AHDSGuidance(GuidanceModels(flux, cn, vae), pe, img, gcfg)


def build_stub_guidance_stack(prompt: str, negative_prompt: str,
                              image_size: int = 64, seed: int = 0,
                              device="cuda",
                              dtype=torch.float32) -> AHDSGuidance:
    """Tiny random models (N(0, 0.05) kernels, as the JAX package's
    fast_init; float32 parameters computed at `dtype`) and the fake text
    encoder: the weight-free smoke stack. On a CUDA device `dtype` must be
    bfloat16: every stride-1 3x3 conv there is K3, which takes bf16 only;
    other dtypes are refused here rather than at the first guided step."""
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(
            f"build_stub_guidance_stack: dtype {dtype} on a CUDA device; the "
            "3x3 convs run on K3 (ops/conv3x3_cuda.py), which takes "
            "torch.bfloat16 only")
    gen = torch.Generator(device=device).manual_seed(seed)
    ucfg = tiny_unet_config(ip_tokens=4, dtype=dtype)
    unet = _build(lambda: UNet2DConditionModel(ucfg), gen, device, 0.05)
    cn = _build(lambda: ControlNetModel(
        ucfg, conditioning_embed_channels=(8, 16)), gen, device, 0.05)
    vae = _build(lambda: AutoencoderKL(tiny_vae_config(dtype=dtype)), gen,
                 device, 0.05)
    pe = make_prompt_embeddings(fake_text_encoder(77, 32), prompt,
                                negative_prompt, "", device=device)
    img = ImageEmbeds(pos=torch.full((1, 4, 32), 0.01, device=device),
                      null=torch.zeros((1, 4, 32), device=device),
                      neg=torch.zeros((1, 4, 32), device=device))
    gcfg = GuidanceConfig(image_size=image_size)
    return AHDSGuidance(GuidanceModels(unet, cn, vae), pe, img, gcfg)


def refine_models(guidance: AHDSGuidance) -> RefineModels:
    """Stage 2's models: the guidance stack's UNet (LoRA folded, 4 IP
    tokens), ControlNet and VAE, which the recipe loads from the same
    checkpoints for both stages."""
    return RefineModels(*guidance.models)


def random_refine_contexts(seed: int = 0, device="cuda") -> dict:
    """The 32 views' (negative, positive) [2, 81, 768] contexts at full
    width: fake 77 x 768 text of the recipe's prompt with each view's
    suffix, and identity tokens from a random ProjPlusModel (s_scale 0.5,
    shortcut) on a random unit ArcFace vector and random CLIP hidden
    states, zeros for the uncond row."""
    gen = torch.Generator(device=device).manual_seed(seed)
    proj, ids, clip = _random_faces(gen, device)
    ip_cond, ip_uncond = refine_identity_tokens(proj, ids[:1], clip[0],
                                                clip[2])
    return refine_contexts(fake_text_encoder(77, 768), RECIPE_PROMPT,
                           ip_cond, ip_uncond, device)


def build_random_lpips(seed: int = 0, device="cuda") -> LPIPS:
    """Stage 3's LPIPS at VGG16 width with seeded random weights: lecun
    normal convs, zero biases, N(0, 1/C) linear heads (the distance takes
    their |w|), float32; frozen."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = _build(lambda: LPIPS(VGG16_STAGES), gen, device)
    with torch.no_grad():
        for i, (ch, _) in enumerate(VGG16_STAGES):
            getattr(m, f"lin_{i}").normal_(0.0, 1.0 / ch, generator=gen)
    return m.requires_grad_(False)
