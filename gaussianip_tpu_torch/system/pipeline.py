"""Assembly of the diffusion guidance stack (port of the weight-free parts
of gaussianip_tpu/system/pipeline.py).

  * `build_random_sd15_guidance`: the recipe's stack at its full published
    widths (SD1.5 UNet with IP-Adapter tokens, OpenPose ControlNet, SD VAE,
    IP-Adapter-FaceID-Plus ProjPlusModel, 77 x 768 text embeddings) with
    seeded random float32 weights computed at bf16, and the guidance
    settings of configs/exp.yaml. The released checkpoints, the CLIP
    encoders and insightface are not in the repository; their loaders are
    not ported yet.
  * `build_stub_guidance_stack`: the tiny weight-free stack for smoke runs.
  * Stage 2 runs the same UNet, ControlNet and VAE (`refine_models`), with
    identity tokens at s_scale 0.5 (`random_refine_contexts`); stage 3's
    LPIPS at VGG16 width with random weights is `build_random_lpips`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..diffusion.ip_adapter import ProjPlusModel
from ..diffusion.lpips import LPIPS, VGG16_STAGES
from ..diffusion.unet import (
    ControlNetModel,
    UNet2DConditionModel,
    UNetConfig,
    tiny_unet_config,
)
from ..diffusion.vae import AutoencoderKL, VAEConfig, tiny_vae_config
from ..guidance.ipa import (
    AHDSGuidance,
    GuidanceConfig,
    GuidanceModels,
    ImageEmbeds,
    compute_image_embeds,
)
from ..guidance.prompts import fake_text_encoder, make_prompt_embeddings
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


def _random_faces(gen: torch.Generator, device):
    """A random ProjPlusModel (bf16), two random unit ArcFace vectors [2,
    512] (the positive and the irrelevant face) and three random CLIP
    hidden states [3, 1, 257, 1280] (positive, irrelevant, zero image)."""
    proj = _build(lambda: ProjPlusModel(dtype=torch.bfloat16), gen, device)
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
