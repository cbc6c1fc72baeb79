"""Builds what a cell runs from a configuration file, for either side: the
program (`PROGRAM`, the port) or the plain reference (`REFERENCE`, its
frozen copy under reference/gip_ref). Both packages have the same module
layout, so one builder serves both; a side's modules are imported by name
only when it is built, and the reference's never import the port."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch

from . import inputs

PROGRAM = "gaussianip_tpu_torch"
REFERENCE = "benchmark.reference.gip_ref"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def package(root: str) -> SimpleNamespace:
    """The modules a cell uses, of the package `root`."""
    names = ("data.sampler", "diffusion.lpips", "diffusion.unet",
             "diffusion.vae", "guidance.ipa",
             "guidance.prompts", "model.adam", "model.densify",
             "model.gaussians", "ops.knn", "render.render", "system.refine",
             "system.stage1", "system.stage3")
    return SimpleNamespace(**{n.split(".")[1]: importlib.import_module(
        f"{root}.{n}") for n in names})


def unet_configs(pkg, cfg: dict, dtype):
    """(UNetConfig of the UNet, UNetConfig of the ControlNet)."""
    u = dict(cfg["unet"])
    u["block_out_channels"] = tuple(u["block_out_channels"])
    unet = pkg.unet.UNetConfig(dtype=dtype, **u)
    return unet, pkg.unet.UNetConfig(
        dtype=dtype, **{**u, "ip_tokens": cfg["controlnet"]["ip_tokens"]})


def diffusion_models(pkg, cfg: dict, seed: int, device, dtype):
    """(unet, controlnet, vae) with the seed's weights."""
    ucfg, ccfg = unet_configs(pkg, cfg, dtype)
    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    vcfg = pkg.vae.VAEConfig(dtype=dtype, **v)
    emb = tuple(cfg["controlnet"]["conditioning_embed_channels"])
    made = []
    for what, ctor, zero in (
            ("unet", lambda: pkg.unet.UNet2DConditionModel(ucfg), 0.0),
            ("controlnet", lambda: pkg.unet.ControlNetModel(
                ccfg, conditioning_embed_channels=emb),
             cfg["init"]["zero_conv_scale"]),
            ("vae", lambda: pkg.vae.AutoencoderKL(vcfg), 0.0)):
        m = inputs.on_meta(ctor)
        made.append(inputs.load(m, inputs.random_weights(
            m, seed, what, device, zero)))
    return tuple(made)


def guidance(pkg, cfg: dict, models, seed: int, device):
    """The stage-1 guidance (AHDSGuidance) on `models`, with the seed's
    conditioning embeddings."""
    c = cfg["conditioning"]
    e = inputs.embeddings(seed, c["text_tokens"], c["context_dim"],
                          cfg["unet"]["ip_tokens"], c["directions"], device)
    pe = pkg.prompts.PromptEmbeddings(e["text_vd"], e["uncond_vd"],
                                      e["null"], e["text"])
    img = pkg.ipa.ImageEmbeds(e["ip_pos"], e["ip_null"], e["ip_neg"])
    g = dict(cfg["guidance"])
    return pkg.ipa.AHDSGuidance(pkg.ipa.GuidanceModels(*models), pe, img,
                                pkg.ipa.GuidanceConfig(**g))


def avatar(pkg, cfg: dict, seed: int, device):
    """The avatar's GaussianState from the seed's point cloud, as the port
    initialises one (3-NN scales, opacity 0.1)."""
    a = cfg["avatar"]
    pts, colours = inputs.avatar_points(a["points"], seed, device)
    return pkg.gaussians.create_from_pcd(
        pts, colours, a["capacity"], pkg.knn.mean_dist2_3nn(pts),
        a["sh_degree"], device=device)


def lpips(pkg, cfg: dict, seed: int, device):
    """Stage 3's LPIPS at VGG16 width with the seed's weights: lecun normal
    convs, zero biases, N(0, 1 / C) linear heads (the distance takes their
    |w|), float32, frozen."""
    stages = tuple(tuple(s) for s in cfg["lpips"]["stages"])
    m = inputs.on_meta(lambda: pkg.lpips.LPIPS(stages))
    state = inputs.random_weights(m, seed, "lpips", device)
    gen = inputs.generator(seed, "lpips_heads", device)
    heads = torch.randn(sum(c for c, _ in stages), generator=gen,
                        device=device)
    off = 0
    for i, (ch, _) in enumerate(stages):
        state[f"lin_{i}"] = heads[off:off + ch] / ch
        off += ch
    return inputs.load(m, state)


def program_counters() -> dict:
    """The port's kernel launch counters (each wrapper's `.launches`)."""
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3
    from gaussianip_tpu_torch.render import composite_cuda as cc

    return {"K1": cc.composite_fwd_cuda,
            "K2": cc.composite_bwd_gaussians_cuda, "K3": k3.conv3x3_cuda}
