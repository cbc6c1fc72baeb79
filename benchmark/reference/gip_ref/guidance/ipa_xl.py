"""The stage-1 AHDS / ANPG guidance of guidance/ipa.py on the SDXL stack
(diffusion/unet_xl.py), plain PyTorch.

The same step as AHDSGuidance, with what SDXL adds: each CFG row (pos,
neg, null) carries its prompt's pooled text embedding, looked up by the
same view direction as its text, and the time ids of an image_size^2
image (original size, crop top-left (0, 0), target size), both handed to
the ControlNet and the UNet.

The VAE encode keeps no activations for the backward: each view is
encoded under torch.utils.checkpoint and encoded again when the gradient
reaches it, so that the float32 encode of 4 views at 1024^2 fits on one
card beside the float32 weights. One view at a time gives each view the
same arithmetic as the batch, since every layer of the encoder acts on
each image alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..diffusion.scheduler import add_noise
from ..ops.resize import linear_resize
from . import ipa
from .ahds import anpg_grad, sample_timesteps, sds_grad, sds_loss
from .ipa import GuidanceConfig, GuidanceModels, ImageEmbeds  # noqa: F401
from .prompts import direction_index


class PromptEmbeddings(NamedTuple):
    """The text tables of prompts.PromptEmbeddings and `pooled`, the same
    four tables of pooled rows ([13, P], [13, P], [P], [P])."""
    text_vd: torch.Tensor
    uncond_vd: torch.Tensor
    null: torch.Tensor
    text: torch.Tensor
    pooled: Optional["PromptEmbeddings"] = None

    def rows(self, idx) -> torch.Tensor:
        """[3B, ...] (pos, neg, null) rows of the directions `idx` [B]."""
        null = self.null[None].expand(idx.shape[0], *self.null.shape)
        return torch.cat([self.text_vd[idx], self.uncond_vd[idx], null])


class AHDSGuidance(ipa.AHDSGuidance):
    """ipa.AHDSGuidance with SDXL's added conditioning; view-dependent
    prompting only (the configuration's)."""

    def encode_images(self, rgb_bhwc, eps):
        size = self.cfg.image_size
        x = linear_resize(rgb_bhwc.permute(0, 3, 1, 2), size, size)
        x = x * 2.0 - 1.0
        enc = self.models.vae.encode
        return torch.cat([checkpoint(enc, x[i:i + 1], eps[i:i + 1],
                                     use_reentrant=False)
                          for i in range(x.shape[0])]).float()

    def __call__(self, step: int, draws, rgb, control_img, view_aux):
        cfg = self.cfg
        if not cfg.view_dependent_prompting:
            raise ValueError("the SDXL reference prompts by view")
        b = rgb.shape[0]
        latents = self.encode_images(rgb, draws["eps"])
        t = sample_timesteps(self.ahds, draws["u"], step)
        size = cfg.image_size
        with torch.no_grad():
            control = linear_resize(control_img.permute(0, 3, 1, 2), size,
                                    size)
            latents_noisy = add_noise(self.ddim, latents.detach(),
                                      draws["noise"], t)
            n_way = 3 if cfg.use_anpg else 2
            idx = direction_index(
                view_aux["elevation"], view_aux["azimuth"],
                view_aux["center"], view_aux["all_vis"],
                view_aux["camera_distances"], cfg.head_offset)
            pe = self.prompt_embeds
            e = self.image_embeds
            img = torch.cat([x.expand(b, -1, -1)
                             for x in (e.pos, e.neg, e.null)])
            context = torch.cat([pe.rows(idx), img], dim=1)[:n_way * b]
            pooled = pe.pooled.rows(idx)[:n_way * b]
            ids = torch.tensor([size, size, 0, 0, size, size],
                               dtype=torch.float32,
                               device=pooled.device).expand(n_way * b, 6)
            lat = torch.cat([latents_noisy] * n_way)
            tt = torch.cat([t] * n_way)
            down_res, mid = None, None
            m = self.models
            if cfg.use_pose_controlnet:
                down_res, mid = m.controlnet(
                    lat, tt, context, torch.cat([control] * n_way),
                    conditioning_scale=1.0, added_cond=(pooled, ids))
            pred = m.unet(lat, tt, context, down_block_residuals=down_res,
                          mid_block_residual=mid, ip_scale=cfg.ipa_scale,
                          added_cond=(pooled, ids)).float()
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
