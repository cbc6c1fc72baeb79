"""Operation and byte counts of the SDXL stack (benchmark/flops.py's, on
the plain reference's SDXL modules on the meta device): one ControlNet +
UNet call with its transformer blocks counted apart, K3's stride-1 3x3
convs, and the VAE encode."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import stack, stack_xl
from .flops import _counted


def _meta_models(cfg: dict):
    pkg = stack_xl.package(stack.REFERENCE)
    ucfg, ccfg = stack.unet_configs(pkg, cfg, torch.float32)
    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    emb = tuple(cfg["controlnet"]["conditioning_embed_channels"])
    with torch.device("meta"):
        return (pkg.unet.UNet2DConditionModel(ucfg),
                pkg.unet.ControlNetModel(ccfg,
                                         conditioning_embed_channels=emb),
                pkg.vae.AutoencoderKL(pkg.vae.VAEConfig(**v)))


def denoise_call(cfg: dict, batch: int, latent: int) -> dict:
    """One ControlNet + UNet call at `batch` rows of latent^2 latents:
    {"flops": total, "transformer_flops": the Transformer2D layers' share,
    "k3_flops", "k3_bytes", "k3_sites"}."""
    unet, cn, _ = _meta_models(cfg)
    c = cfg["conditioning"]
    m = dict(device="meta")
    lat = torch.empty(batch, cfg["unet"]["in_channels"], latent, latent, **m)
    t = torch.zeros(batch, dtype=torch.int64, **m)
    ctx = torch.empty(batch, c["text_tokens"] + cfg["unet"]["ip_tokens"],
                      c["context_dim"], **m)
    added = (torch.empty(batch, c["pooled_dim"], **m),
             torch.empty(batch, 6, **m))
    side = latent * (2 ** (len(cfg["vae"]["block_out_channels"]) - 1))
    control = torch.empty(batch, 3, side, side, **m)
    fc = FlopCounterMode(display=False)
    k3 = {"flops": 0, "bytes": 0, "sites": 0}
    tf = {"flops": 0, "at": 0}

    def conv_hook(mod, args, out):
        if mod.stride != 1:
            return
        b, ci, h, w = args[0].shape
        co = mod.weight.shape[0]
        k3["flops"] += 2 * b * h * w * ci * co * 9
        k3["bytes"] += 2 * (b * h * w * (ci + co) + 9 * ci * co)
        k3["sites"] += 1

    def tf_in(mod, args):
        tf["at"] = fc.get_total_flops()

    def tf_out(mod, args, out):
        tf["flops"] += fc.get_total_flops() - tf["at"]

    hooks = []
    for net in (unet, cn):
        for mod in net.modules():
            kind = type(mod).__name__
            if kind == "Conv3x3":
                hooks.append(mod.register_forward_hook(conv_hook))
            elif kind == "Transformer2D":
                hooks += [mod.register_forward_pre_hook(tf_in),
                          mod.register_forward_hook(tf_out)]
    with fc, torch.no_grad():
        res, mid = cn(lat, t, ctx, control, added_cond=added)
        unet(lat, t, ctx, down_block_residuals=res, mid_block_residual=mid,
             ip_scale=1.0, added_cond=added)
    for h in hooks:
        h.remove()
    return {"flops": fc.get_total_flops(), "transformer_flops": tf["flops"],
            "k3_flops": k3["flops"], "k3_bytes": k3["bytes"],
            "k3_sites": k3["sites"]}


def vae_encode(cfg: dict, batch: int, side: int,
               backward: bool = False) -> int:
    """flops.vae_encode for this configuration's VAE."""
    _, _, vae = _meta_models(cfg)
    vae.requires_grad_(False)
    x = torch.empty(batch, 3, side, side, device="meta",
                    requires_grad=backward)
    lat = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    eps = torch.empty(batch, cfg["vae"]["latent_channels"], side // lat,
                      side // lat, device="meta")

    def call():
        z = vae.encode(x, eps)
        if backward:
            z.sum().backward()

    return _counted(call)
