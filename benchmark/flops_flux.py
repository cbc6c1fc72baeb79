"""Operation counts of the FLUX.1-dev stack (benchmark/flops.py's method,
on the plain reference's modules on the meta device): one ControlNet +
transformer call with the double-stream and the single-stream blocks'
operations counted apart (each block whole: its projections, MLP,
attention and, in the transformer's double blocks, the IP attention),
and the VAE encode."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import stack, stack_flux
from .flops import _counted


def _meta_models(cfg: dict):
    return stack_flux.models_on_meta(stack_flux.package(stack.REFERENCE),
                                     cfg, torch.float32)


def denoise_call(cfg: dict, batch: int, latent: int) -> dict:
    """One ControlNet + transformer call at `batch` rows of latent^2
    latents (packed to (latent / 2)^2 tokens): {"flops": total,
    "double_flops", "single_flops": the blocks' shares}."""
    flux, cn, _ = _meta_models(cfg)
    t, c = cfg["transformer"], cfg["conditioning"]
    m = dict(device="meta")
    side = latent // 2
    img = torch.empty(batch, side, side, t["in_channels"], **m)
    sigma = torch.empty(batch, **m)
    txt = torch.empty(batch, c["text_tokens"], t["joint_attention_dim"],
                      **m)
    pooled = torch.empty(batch, c["pooled_dim"], **m)
    ip = (torch.empty(batch, t["ip_tokens"], t["ip_dim"], **m)
          if t["ip_tokens"] else None)
    fc = FlopCounterMode(display=False)
    got = {"DoubleStreamBlock": 0, "SingleStreamBlock": 0}
    at = {}

    def enter(mod, args):
        at[mod] = fc.get_total_flops()

    def leave(mod, args, out):
        got[type(mod).__name__] += fc.get_total_flops() - at.pop(mod)

    hooks = []
    for net in (flux, cn):
        for mod in net.modules():
            if type(mod).__name__ in got:
                hooks += [mod.register_forward_pre_hook(enter),
                          mod.register_forward_hook(leave)]
    with fc, torch.no_grad():
        samples = cn(img, img, sigma, sigma, txt, pooled)
        flux(img, sigma, sigma, txt, pooled, ip, 1.0, samples)
    for h in hooks:
        h.remove()
    return {"flops": fc.get_total_flops(),
            "double_flops": got["DoubleStreamBlock"],
            "single_flops": got["SingleStreamBlock"]}


def vae_encode(cfg: dict, batch: int, side: int,
               backward: bool = False) -> int:
    """The VAE encode of `batch` side^2 images; with `backward`, the
    posterior sampled and the gradient to the images (the weights are
    frozen), else the posterior's mean (the pose maps')."""
    _, _, vae = _meta_models(cfg)
    vae.requires_grad_(False)
    x = torch.empty(batch, 3, side, side, device="meta",
                    requires_grad=backward)
    lat = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    eps = (torch.empty(batch, cfg["vae"]["latent_channels"], side // lat,
                       side // lat, device="meta") if backward else None)

    def call():
        z = vae.encode(x, eps)
        if backward:
            z.sum().backward()

    return _counted(call)
