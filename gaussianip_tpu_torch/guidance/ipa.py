"""The AHDS / ANPG diffusion guidance of stage 1 (port of
gaussianip_tpu/guidance/ipa.py).

One call: VAE-encode the rendered views (with autograd), draw the
AHDS-windowed timesteps, run ControlNet + UNet once on the 3-way CFG batch
[pos, neg, null] x B under torch.no_grad() (the UNet is a frozen scorer),
form the ANPG gradient and return the SDS-shaped loss whose latent
gradient is that gradient; the gradient reaches rgb only through the VAE
encode. The random draws come from `sample_noise`, in a dict the caller
passes back.

At 64^2 latents on a card the ControlNet + UNet call replays from a CUDA
graph captured once per input signature (guidance/graph.py); larger
latents and CPU tensors run it eagerly.

The conditioning is the 77 text tokens of the view's prompt with the 4
identity tokens of ProjPlusModel appended (81 tokens), for both the UNet
(which splits the identity tokens off to its IP projections) and the
ControlNet (which attends over all 81). An SDXL stack (models with the
added embedding) also takes each CFG row's pooled text embedding and the
time ids of an image_size^2 image.

A velocity prior (a denoiser whose `prediction` is "velocity":
FLUX.1-dev's rectified-flow transformer and its Union ControlNet,
diffusion/flux.py, in place of the UNet and the ControlNet) runs under
the same AHDS schedule and ANPG gradient, which are written for an
epsilon prediction on DDPM's alphas_cumprod a_t, through a bridge:
  sigma_t = sqrt(1 - a_t) / (sqrt(a_t) + sqrt(1 - a_t)), the flow's noise
    level with DDPM's signal-to-noise ratio at t;
  x_t = (1 - sigma_t) z + sigma_t eps = c_t add_noise(z, eps, t), c_t =
    1 / (sqrt(a_t) + sqrt(1 - a_t));
  the transformer takes sigma_t; eps^ = x_t + (1 - sigma_t) v^, which is
    eps exactly where v^ = eps - z.
The three rows' eps^ feed anpg_grad as a UNet's would; w(t) and its t <
170 mask stay on DDPM's t. The latents go to the networks packed 2 x 2
(flux.pack). Each step also encodes the pose maps at image_size through
the same VAE (the posterior mean, under no_grad; the span `pose_encode`)
as the ControlNet's hint. The T5 tokens go to the transformer and the
ControlNet, the pooled vector and the embedded guidance g
(EMBEDDED_GUIDANCE) to their conditioning vector,
the identity tokens to the transformer's IP projections only. The spans
are `controlnet` and `flux`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..diffusion.flux import pack, unpack
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
from .graph import DenoiseGraph
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
    unet: nn.Module  # the denoiser: a UNet, or FLUX's transformer
    controlnet: nn.Module
    vae: nn.Module


# g, the embedded guidance of the velocity prior's every CFG row
# (FLUX.1-dev's pipeline's default guidance_scale)
EMBEDDED_GUIDANCE = 3.5


class AHDSGuidance:
    """Guidance for system/stage1.make_train_step. The models are frozen:
    their parameters take no gradient. `__call__` runs `predict_noise`
    (a velocity prior: `predict_velocity`) through `denoise_graph`
    (guidance/graph.py), whose graphs read the
    parameters by address: a weight changed in place is seen by the next
    replay, a parameter rebound to a new tensor is not."""

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
        self.denoise_graph = DenoiseGraph()

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

    def predict_velocity(self, latents, hint, sigma, txt, pooled, ip):
        """One ControlNet + transformer pass of a velocity prior on an
        already-expanded batch: latents [R, C, h, w] (x_t), hint the packed
        pose latents, sigma [R] -> the velocity [R, C, h, w], float32."""
        m = self.models
        g = torch.full_like(sigma, EMBEDDED_GUIDANCE)
        img = pack(latents)
        samples = None
        if self.cfg.use_pose_controlnet:
            with span("controlnet"):
                samples = m.controlnet(img, hint, sigma, g, txt, pooled)
        with span("flux"):
            return unpack(m.unet(img, sigma, g, txt, pooled, ip,
                                 self.cfg.ipa_scale, samples)).float()

    def _velocity_as_eps(self, latents_noisy, control, t, view_aux,
                         n_way: int):
        """[n_way B, C, h, w]: the velocity prior's eps^ of each CFG row
        (the bridge of the module's docstring)."""
        b = t.shape[0]
        a = self.ddim.alphas_cumprod[t]
        ra, rs = torch.sqrt(a), torch.sqrt(1.0 - a)
        c = 1.0 / (ra + rs)
        sigma = torch.cat([rs * c] * n_way)
        x_t = torch.cat([c[:, None, None, None] * latents_noisy] * n_way)
        with span("pose_encode"):
            hint = pack(self.models.vae.encode(control * 2.0 - 1.0))
        txt = self._text_rows(self.prompt_embeds, view_aux)[:n_way * b]
        pooled = self._text_rows(self.prompt_embeds.pooled,
                                 view_aux)[:n_way * b]
        ip = None
        if self.image_embeds is not None:
            e = self.image_embeds
            ip = torch.cat([x.expand(b, -1, -1)
                            for x in (e.pos, e.neg, e.null)])[:n_way * b]
        v = self.denoise_graph(self.predict_velocity, x_t,
                               torch.cat([hint] * n_way), sigma, txt, pooled,
                               ip)
        return x_t + (1.0 - sigma)[:, None, None, None] * v

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
            if self.models.unet.prediction == "velocity":
                pred = self._velocity_as_eps(latents_noisy, control, t,
                                             view_aux, n_way)
            else:
                context = self._context(view_aux, b)[:n_way * b]
                added = self._added_cond(view_aux)
                if added is not None:
                    added = tuple(x[:n_way * b] for x in added)
                pred = self.denoise_graph(
                    self.predict_noise, torch.cat([latents_noisy] * n_way),
                    torch.cat([control] * n_way), torch.cat([t] * n_way),
                    context, added)
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
