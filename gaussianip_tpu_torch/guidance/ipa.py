"""The AHDS / ANPG diffusion guidance of stage 1 (port of
gaussianip_tpu/guidance/ipa.py).

One call: VAE-encode the rendered views (with autograd), draw the
AHDS-windowed timesteps, run ControlNet + UNet once on the 3-way CFG batch
[pos, neg, null] x B under torch.no_grad() (the UNet is a frozen scorer),
form the ANPG gradient and return the SDS-shaped loss whose latent
gradient is that gradient; the gradient reaches rgb only through the VAE
encode. The random draws come from `sample_noise`, in a dict the caller
passes back.

The conditioning is the 77 text tokens of the view's prompt with the 4
identity tokens of ProjPlusModel appended (81 tokens), for both the UNet
(which splits the identity tokens off to its IP projections) and the
ControlNet (which attends over all 81). An SDXL stack (models with the
added embedding) also takes each CFG row's pooled text embedding and the
time ids of an image_size^2 image.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..diffusion.scheduler import DDIMSchedule, add_noise, make_ddim_schedule
from ..diffusion.unet import time_ids
from ..ops.resize import linear_resize
from ..utils.profiling import span
from .ahds import (
    AHDSSchedule,
    anpg_grad,
    make_ahds_schedule,
    sample_timesteps,
    sds_grad,
    sds_loss,
)
from .prompts import PromptEmbeddings


@dataclass(frozen=True)
class GuidanceConfig:
    guidance_scale: float = 7.5
    guidance_rescale: float = 0.75
    ipa_scale: float = 0.5  # ipa_faceid_scale (configs/exp.yaml)
    weighting_strategy: str = "sds"
    use_anpg: bool = True
    use_pose_controlnet: bool = True
    view_dependent_prompting: bool = True
    grad_clip_pixel: bool = True
    grad_clip_threshold: float = 1.0
    head_offset: float = 0.65
    # the latents' side is image_size over the VAE's downscale
    image_size: int = 512


class ImageEmbeds(NamedTuple):
    pos: torch.Tensor  # [1, T_ip, D]
    null: torch.Tensor
    neg: torch.Tensor


class GuidanceModels(NamedTuple):
    unet: nn.Module
    controlnet: nn.Module
    vae: nn.Module


class AHDSGuidance:
    """Guidance for system/stage1.make_train_step. The models are frozen:
    their parameters take no gradient."""

    def __init__(self, models: GuidanceModels,
                 prompt_embeds: PromptEmbeddings,
                 image_embeds: Optional[ImageEmbeds],
                 cfg: GuidanceConfig = GuidanceConfig(),
                 ddim: Optional[DDIMSchedule] = None,
                 ahds: Optional[AHDSSchedule] = None):
        for m in models:
            m.requires_grad_(False)
        self.models = models
        self.prompt_embeds = prompt_embeds
        self.image_embeds = image_embeds
        self.cfg = cfg
        dev = next(models.unet.parameters()).device
        self.ddim = ddim or make_ddim_schedule(device=dev)
        self.ahds = ahds or make_ahds_schedule()

    def latent_shape(self, batch_size: int) -> tuple:
        vcfg = self.models.vae.cfg
        s = self.cfg.image_size // vcfg.downscale
        return (batch_size, vcfg.latent_channels, s, s)

    def sample_noise(self, generator: torch.Generator, shape, device):
        """The step's draws from `generator`, in this order: "u" [B] int in
        [0, 2**30) (the timestep draw), "noise" (the forward-diffusion
        noise) and "eps" (the VAE posterior's), both latent-shaped. `shape`
        is the render's [B, H, W, 3]."""
        b = shape[0]
        u = torch.randint(0, 1 << 30, (b,), generator=generator,
                          device=device)
        lat = self.latent_shape(b)
        noise = torch.randn(lat, generator=generator, device=device)
        eps = torch.randn(lat, generator=generator, device=device)
        return {"u": u, "noise": noise, "eps": eps}

    def _text_rows(self, table, view_aux):
        return table.get_text_embeddings(
            view_aux["elevation"], view_aux["azimuth"], view_aux["center"],
            view_aux["all_vis"], view_aux["camera_distances"],
            view_dependent=self.cfg.view_dependent_prompting,
            head_offset=self.cfg.head_offset)

    def _context(self, view_aux, batch_size: int):
        """[3B, S (+ T_ip), D] stacked (pos, neg, null) conditioning."""
        text = self._text_rows(self.prompt_embeds, view_aux)
        if self.image_embeds is None:
            return text
        e = self.image_embeds
        rep = lambda x: x.expand(batch_size, -1, -1)
        img = torch.cat([rep(e.pos), rep(e.neg), rep(e.null)], dim=0)
        return torch.cat([text, img.to(text.dtype)], dim=1)

    def _added_cond(self, view_aux):
        """SDXL's (pooled [3B, P], time ids [3B, 6]) of the stacked rows,
        or None where the prompts carry no pooled embeddings."""
        pooled = self.prompt_embeds.pooled
        if pooled is None:
            return None
        rows = self._text_rows(pooled, view_aux)
        size = self.cfg.image_size
        return rows, time_ids(size, size, rows.shape[0], rows.device)

    def encode_images(self, rgb_bhwc, eps):
        """[B, H, W, 3] in [0, 1] -> scaled float32 latents [B, 4, h, w]."""
        size = self.cfg.image_size
        x = linear_resize(rgb_bhwc.permute(0, 3, 1, 2), size, size)
        return self.models.vae.encode(x * 2.0 - 1.0, eps).float()

    def predict_noise(self, latents_noisy, control, t, context,
                      added_cond=None):
        """One ControlNet + UNet pass on an already-expanded batch."""
        m = self.models
        down_res, mid = None, None
        if self.cfg.use_pose_controlnet:
            with span("controlnet"):
                down_res, mid = m.controlnet(latents_noisy, t, context,
                                             control, conditioning_scale=1.0,
                                             added_cond=added_cond)
        with span("unet"):
            return m.unet(latents_noisy, t, context,
                          down_block_residuals=down_res,
                          mid_block_residual=mid,
                          ip_scale=self.cfg.ipa_scale,
                          added_cond=added_cond).float()

    def __call__(self, step: int, draws, rgb, control_img, view_aux):
        cfg = self.cfg
        b = rgb.shape[0]
        with span("vae_encode"):
            latents = self.encode_images(rgb, draws["eps"])
        t = sample_timesteps(self.ahds, draws["u"], step)
        size = cfg.image_size
        with torch.no_grad(), span("denoise"):
            control = linear_resize(control_img.permute(0, 3, 1, 2), size,
                                    size)
            latents_noisy = add_noise(self.ddim, latents.detach(),
                                      draws["noise"], t)
            n_way = 3 if cfg.use_anpg else 2
            context = self._context(view_aux, b)[:n_way * b]
            added = self._added_cond(view_aux)
            if added is not None:
                added = tuple(x[:n_way * b] for x in added)
            pred = self.predict_noise(
                torch.cat([latents_noisy] * n_way), torch.cat([control]
                                                              * n_way),
                torch.cat([t] * n_way), context, added)
            ac = self.ddim.alphas_cumprod
            if cfg.use_anpg:
                e_pos, e_neg, e_null = pred.chunk(3)
                grad = anpg_grad(e_neg, e_pos, e_null, t, ac,
                                 cfg.guidance_scale, cfg.weighting_strategy,
                                 cfg.grad_clip_pixel,
                                 cfg.grad_clip_threshold)
            else:
                e_pos, e_neg = pred.chunk(2)
                grad = sds_grad(e_neg, e_pos, draws["noise"], t, ac,
                                cfg.guidance_scale, cfg.weighting_strategy,
                                cfg.guidance_rescale)
        return {
            "loss_sds": sds_loss(latents, grad,
                                 view_aux.get("batch_size", b)),
            "grad_norm": torch.linalg.vector_norm(grad),
            "t_mean": t.float().mean(),
        }


def compute_image_embeds(proj_model, pos_id_embed, irr_id_embed,
                         pos_clip_hidden, irr_clip_hidden, zero_clip_hidden,
                         s_scale: float = 0.4,
                         shortcut: bool = True) -> ImageEmbeds:
    """ProjPlus triple: (real, irrelevant, zeros) -> (pos, null, neg)."""
    with torch.no_grad():
        run = lambda ide, ch: proj_model(ide, ch, shortcut=shortcut,
                                         scale=s_scale)
        return ImageEmbeds(pos=run(pos_id_embed, pos_clip_hidden),
                           null=run(irr_id_embed, irr_clip_hidden),
                           neg=run(torch.zeros_like(pos_id_embed),
                                   zero_clip_hidden))
