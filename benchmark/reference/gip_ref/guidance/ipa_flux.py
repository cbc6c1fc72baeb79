"""The stage-1 AHDS / ANPG guidance of guidance/ipa.py with FLUX.1-dev's
velocity prior (diffusion/flux.py, diffusion/vae_flux.py), plain PyTorch.

The AHDS schedule and anpg_grad are written for an epsilon prediction on
DDPM's alphas_cumprod a_t; the velocity prior reaches them through this
bridge, written out:
  sigma_t = sqrt(1 - a_t) / (sqrt(a_t) + sqrt(1 - a_t)), the flow's noise
    level with DDPM's signal-to-noise ratio at t;
  x_t = (1 - sigma_t) z + sigma_t eps, the rectified flow's noisy latents;
  the ControlNet and the transformer take sigma_t and the embedded
    guidance g; eps^ = x_t + (1 - sigma_t) v^.
The three rows' eps^ (pos, neg, null) feed anpg_grad; w(t) and its t < 170
mask stay on DDPM's t. The latents are packed 2 x 2 (each 2 x 2 patch of
the 16 channels a 64-wide token, channels in (c, ph, pw) order) and
unpacked after. The pose maps, resized to image_size, are encoded through
the same VAE (the posterior mean, no gradient) and packed: the
ControlNet's hint. The T5 tokens go to the transformer and the
ControlNet, the pooled vector to both conditioning vectors, the identity
tokens to the transformer's IP projections only.

To fit beside the float32 weights (62.7 GB): the VAE encode keeps no
activations for the backward (each view under torch.utils.checkpoint,
encoded again when the gradient reaches it, and in that encode each
block of the encoder under its own checkpoint), the pose maps are
encoded one at a time, and each CFG row goes through the ControlNet and
the transformer alone. Every layer of both acts on each row (and every
layer of the encoder on each image) alone, so the arithmetic is the
batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.resize import linear_resize
from . import ipa
from .ahds import anpg_grad, sample_timesteps, sds_grad, sds_loss
from .ipa import GuidanceConfig, GuidanceModels, ImageEmbeds  # noqa: F401
from .ipa_xl import PromptEmbeddings  # noqa: F401
from .prompts import direction_index


# g, the embedded guidance of every CFG row (FLUX.1-dev's pipeline's
# default guidance_scale)
EMBEDDED_GUIDANCE = 3.5


def pack(z):
    """[B, C, H, W] -> [B, H/2, W/2, 4C]."""
    b, c, h, w = z.shape
    z = z.reshape(b, c, h // 2, 2, w // 2, 2)
    return z.permute(0, 2, 4, 1, 3, 5).reshape(b, h // 2, w // 2, 4 * c)


def unpack(x):
    """[B, h, w, 4C] -> [B, C, 2h, 2w]."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, c4 // 4, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c4 // 4, 2 * h, 2 * w)


def _recomputed(f, x):
    return checkpoint(f, x, use_reentrant=False)


def encode_recomputed(vae, images, eps):
    """vae.encode(images, eps) with each block of the encoder (diffusion/
    vae.py's Encoder.forward, step by step) recomputed in the backward."""
    e, cfg = vae.encoder, vae.cfg
    h = _recomputed(e.conv_in, images.to(cfg.dtype).contiguous(
        memory_format=torch.channels_last))
    n = len(cfg.block_out_channels)
    for bi in range(n):
        for li in range(cfg.layers_per_block):
            h = _recomputed(getattr(e, f"down_{bi}_res_{li}"), h)
        if bi < n - 1:
            h = _recomputed(getattr(e, f"down_{bi}_downsample"), h)
    for block in (e.mid_res_0, e.mid_attn, e.mid_res_1):
        h = _recomputed(block, h)
    h = _recomputed(lambda y: e.conv_out(F.silu(e.conv_norm_out(y))), h)
    return vae.latents(h, eps)


class AHDSGuidance(ipa.AHDSGuidance):
    """ipa.AHDSGuidance on a velocity prior; view-dependent prompting only
    (the configuration's)."""

    def encode_images(self, rgb_bhwc, eps):
        size = self.cfg.image_size
        x = linear_resize(rgb_bhwc.permute(0, 3, 1, 2), size, size)
        x = x * 2.0 - 1.0
        enc = lambda xi, ei: encode_recomputed(self.models.vae, xi, ei)
        return torch.cat([checkpoint(enc, x[i:i + 1], eps[i:i + 1],
                                     use_reentrant=False)
                          for i in range(x.shape[0])]).float()

    def __call__(self, step: int, draws, rgb, control_img, view_aux):
        cfg = self.cfg
        if not cfg.view_dependent_prompting:
            raise ValueError("the FLUX reference prompts by view")
        b = rgb.shape[0]
        latents = self.encode_images(rgb, draws["eps"])
        t = sample_timesteps(self.ahds, draws["u"], step)
        size = cfg.image_size
        m = self.models
        with torch.no_grad():
            control = linear_resize(control_img.permute(0, 3, 1, 2), size,
                                    size)
            hint = pack(torch.cat([m.vae.encode(control[i:i + 1] * 2.0 - 1.0)
                                   for i in range(b)]).float())
            a = self.ddim.alphas_cumprod[t]
            sigma = torch.sqrt(1.0 - a) / (torch.sqrt(a)
                                           + torch.sqrt(1.0 - a))
            s4 = sigma[:, None, None, None]
            x_t = (1.0 - s4) * latents.detach() + s4 * draws["noise"]
            n_way = 3 if cfg.use_anpg else 2
            idx = direction_index(
                view_aux["elevation"], view_aux["azimuth"],
                view_aux["center"], view_aux["all_vis"],
                view_aux["camera_distances"], cfg.head_offset)
            pe = self.prompt_embeds
            e = self.image_embeds
            txt = pe.rows(idx)
            pooled = pe.pooled.rows(idx)
            ip = torch.cat([x.expand(b, -1, -1)
                            for x in (e.pos, e.neg, e.null)])
            img = pack(x_t)
            g = torch.full((1,), EMBEDDED_GUIDANCE, device=x_t.device)
            rows = []
            for r in range(n_way * b):
                i = r % b
                one = lambda x: x[r:r + 1]
                samples = None
                if cfg.use_pose_controlnet:
                    samples = m.controlnet(img[i:i + 1], hint[i:i + 1],
                                           sigma[i:i + 1], g, one(txt),
                                           one(pooled))
                v = m.unet(img[i:i + 1], sigma[i:i + 1], g, one(txt),
                           one(pooled), one(ip), cfg.ipa_scale, samples)
                rows.append(x_t[i:i + 1] + (1.0 - s4[i:i + 1])
                            * unpack(v).float())
            pred = torch.cat(rows)
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
