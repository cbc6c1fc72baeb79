"""Stage-2 VCR: view-consistent refinement of 32 orbit views (port of
gaussianip_tpu/system/refine.py), and the stage-1 -> stage-2 handoff.

The 32 stage-1 renders are VAE-encoded (the posterior mean), noised with
one shared draw at the first of the last 8 steps of the 50-step DDIM
ladder, and denoised 8 steps with ControlNet + UNet on the CFG-doubled
batch, the self-attention of the UNet's up blocks shared across views:
  anchors (front = view 24, back 8, left 16, right 0) store their states;
  key views (k0 20, k1 28, k2 4, k3 12) attend over cat(self, their front
    or back anchor) and store their own;
  dense views blend self-attention with attention into their two
    neighbouring stored views (weights 0.75/0.25, 0.5/0.5, 0.25/0.75,
    lambda_self 0.55).
The schedule is step-major: every step runs the anchors batched, then the
keys batched, then the 24 dense views in groups of one weight class, so
only one step's stored states (8 views x 2 CFG rows x 9 layers) are alive.
A CFG-doubled batch holds the uncond rows first, then the cond rows. The
shared noise is an argument.

The handoff (`render_refine_views`, `refine_contexts`) renders the orbit
with its pose maps and builds each view's (negative, positive) context.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from ..diffusion.scheduler import (
    DDIMSchedule,
    add_noise,
    ddim_step,
    make_ddim_schedule,
    refine_timestep_ladder,
)
from ..diffusion.unet import time_ids
from ..human.posemap import openpose_draw
from ..ops.resize import linear_resize
from ..parallel.mesh import all_sum, gather_rows, is_main, row_span

# processing order and names
VIEW_IDX_ALL = [24, 8, 16, 0, 20, 28, 4, 12, 17, 18, 19, 21, 22, 23, 25, 26,
                27, 29, 30, 31, 1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15]
VIEW_NAME_ALL = ["front", "back", "left", "right", "k0", "k1", "k2", "k3"] + [
    f"v{i}" for i in range(24)]
ANCHOR_NAMES = ["front", "back", "left", "right"]
KEY_NAMES = ["k0", "k1", "k2", "k3"]

PROMPT_SUFFIX = {
    "front": "", "back": ", back view", "left": ", left view",
    "right": ", right view", "k0": ", left front view",
    "k1": ", right front view", "k2": ", right back view",
    "k3": ", left back view",
}
REFINE_NEGATIVE_PROMPT = ("blurry face, bad face, poorly drawn face, "
                          "duplicate face, extra fingers, blurry, fused fingers")

# dense view -> (left stored view, right stored view) and their weights
KEY_VIEW_NAME_PAIR = {
    "v0": ("left", "k0"), "v1": ("left", "k0"), "v2": ("left", "k0"),
    "v3": ("k0", "front"), "v4": ("k0", "front"), "v5": ("k0", "front"),
    "v6": ("front", "k1"), "v7": ("front", "k1"), "v8": ("front", "k1"),
    "v9": ("k1", "right"), "v10": ("k1", "right"), "v11": ("k1", "right"),
    "v12": ("right", "k2"), "v13": ("right", "k2"), "v14": ("right", "k2"),
    "v15": ("k2", "back"), "v16": ("k2", "back"), "v17": ("k2", "back"),
    "v18": ("back", "k3"), "v19": ("back", "k3"), "v20": ("back", "k3"),
    "v21": ("k3", "left"), "v22": ("k3", "left"), "v23": ("k3", "left"),
}
KEY_VIEW_WEIGHT_PAIR = {
    f"v{i}": [(0.75, 0.25), (0.5, 0.5), (0.25, 0.75)][i % 3] for i in range(24)
}
ANCHOR_OF_KEY = {"k0": "front", "k1": "front", "k2": "back", "k3": "back"}

LAMBDA_SELF = 0.55
NUM_REFINE_STEPS = 8
VAE_CHUNK = 2  # images per VAE call at 1024^2
RENDER_BATCH = 4  # views per render sweep, as a stage-3 step renders
HEAD_OFFSET = 0.65  # center_z of the head-zoomed views (pose maps)

# the stage-3 targets: this crop of the 1024^2 views, then x0.5
CROP_Y = (60, 890)
CROP_X = (220, 800)


class RefineModels(NamedTuple):
    unet: nn.Module
    controlnet: nn.Module
    vae: nn.Module


def view_index(name: str) -> int:
    return VIEW_IDX_ALL[VIEW_NAME_ALL.index(name)]


def make_refine_step(models: RefineModels, ddim: DDIMSchedule,
                     guidance_scale: float, ip_scale: float):
    """`run(latents, t, t_prev, context, control, vcr_mode="off",
    vcr_cache=None, vcr_weights=None, added_cond=None) -> (latents,
    cache)`: one DDIM step of B views. latents [B, 4, h, w] float32;
    context [2B, S, D] (uncond rows, then cond); control [B, 3, H, W] pose
    maps; the VCR arguments as the UNet takes them, with caches of 2B
    rows; added_cond, an SDXL stack's (pooled [2B, P], time ids [2B, 6]).
    The ControlNet + UNet pass runs on the CFG-doubled batch without
    autograd; cache is what the UNet stored (None outside the store / key
    modes)."""

    @torch.no_grad()
    def run(latents, t: int, t_prev: int, context, control,
            vcr_mode: str = "off", vcr_cache=None, vcr_weights=None,
            added_cond=None):
        b = latents.shape[0]
        dev = latents.device
        lat_in = torch.cat([latents] * 2)
        t_in = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
        down_res, mid = models.controlnet(lat_in, t_in, context,
                                          torch.cat([control] * 2),
                                          conditioning_scale=1.0,
                                          added_cond=added_cond)
        out = models.unet(lat_in, t_in, context,
                          down_block_residuals=down_res,
                          mid_block_residual=mid, ip_scale=ip_scale,
                          vcr_mode=vcr_mode, vcr_cache=vcr_cache,
                          vcr_weights=vcr_weights, added_cond=added_cond)
        eps, cache = out if vcr_mode != "off" else (out, None)
        e_uncond, e_cond = eps.float().chunk(2)
        eps = e_uncond + guidance_scale * (e_cond - e_uncond)
        tt = lambda v: torch.full((b,), v, dtype=torch.int64, device=dev)
        return ddim_step(ddim, eps, tt(t), tt(t_prev), latents), cache

    return run


@torch.no_grad()
def vae_encode(vae, images):
    """[N, H, W, 3] in [0, 1] -> the posterior mean's scaled float32
    latents [N, 4, h, w], VAE_CHUNK images per call."""
    x = images.permute(0, 3, 1, 2) * 2.0 - 1.0
    return torch.cat([vae.encode(x[i:i + VAE_CHUNK]).float()
                      for i in range(0, x.shape[0], VAE_CHUNK)])


@torch.no_grad()
def vae_decode(vae, latents):
    """Scaled latents [N, 4, h, w] -> [N, H, W, 3] float32 in [0, 1],
    VAE_CHUNK per call."""
    return torch.cat([
        torch.clamp((vae.decode(latents[i:i + VAE_CHUNK]).float() + 1.0)
                    / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)
        for i in range(0, latents.shape[0], VAE_CHUNK)])


def _rows(names, table):
    """The CFG-doubled batch's rows of `names` in a cache whose row of name
    n is table[n] = (uncond row, cond row): uncond rows, then cond."""
    return [table[n][0] for n in names] + [table[n][1] for n in names]


def dense_groups(dense_batch: int = 4):
    """The dense views grouped by weight class ((w_l, w_r) in the order
    the classes first appear among v0..v23), `dense_batch` per group:
    [((w_l, w_r), [names])]."""
    classes: dict = {}
    for name in (f"v{i}" for i in range(24)):
        classes.setdefault(KEY_VIEW_WEIGHT_PAIR[name], []).append(name)
    return [(w, members[g:g + dense_batch])
            for w, members in classes.items()
            for g in range(0, len(members), dense_batch)]


def refine_views(models: RefineModels, images, control_images,
                 contexts: dict, noise, ddim: DDIMSchedule | None = None,
                 num_steps: int = NUM_REFINE_STEPS, num_ladder: int = 50,
                 guidance_scale: float = 7.5, ip_scale: float = 0.6,
                 lambda_self: float = LAMBDA_SELF, dense_batch: int = 4,
                 on_phase=None, group=None, pooled: dict | None = None):
    """Refined images [32, H, W, 3] in [0, 1], in canonical view order.

    images, control_images: [32, H, W, 3] in [0, 1] (the stage-1 renders
    and their pose maps, on the models' device); contexts: view name ->
    [2, S, D] (negative, positive); noise: [4, h, w], the draw shared by
    every view's forward diffusion; pooled: for an SDXL stack, view name
    -> [2, P] (negative, positive) pooled text embeddings, the time ids
    those of an H x W image. `on_phase(name)`, if given, is called
    after the VAE encode ("encode"), each denoise call ("anchors", "keys",
    "dense") and the VAE decode ("decode"): timing hooks.

    group: a data-parallel group (parallel/mesh.py), every rank passing
    the same arguments. The VAE encode and decode split the 32 views over
    the ranks and gather them; the anchor and key phases run whole on
    every rank (8 of the 32 views, repeated), so that each rank holds the
    caches its dense views read without gathering them; each dense group's
    views split over the ranks, and their latents are gathered before the
    decode. Every rank returns all 32 views."""
    n_views = images.shape[0]
    if n_views != 32:
        raise ValueError("the VCR topology is defined for 32 views")
    dev = images.device
    ddim = ddim or make_ddim_schedule(device=dev)
    steps = [int(s) for s in refine_timestep_ladder(num_ladder,
                                                    device="cpu")]
    steps = steps[-num_steps:]  # descending
    prevs = steps[1:] + [-1]

    note = on_phase or (lambda name: None)
    lo, hi = row_span(group, n_views)
    latents0 = gather_rows(group, vae_encode(models.vae, images[lo:hi]),
                           n_views)
    note("encode")
    lat = add_noise(ddim, latents0,
                    noise.to(latents0).expand_as(latents0),
                    torch.full((n_views,), steps[0], dtype=torch.int64,
                               device=dev))
    run = make_refine_step(models, ddim, guidance_scale, ip_scale)
    control = control_images.permute(0, 3, 1, 2)

    def rows(table, names):
        """[2B, ...]: the uncond rows of the views, then the cond rows."""
        return torch.cat([torch.stack([table[n][k] for n in names])
                          for k in (0, 1)])

    def batch(names):
        """(view indices, [2B, S, D] context, [B, 3, H, W] pose maps,
        the added conditioning of the 2B rows or None)"""
        idx = torch.tensor([view_index(n) for n in names], device=dev)
        added = None
        if pooled is not None:
            added = (rows(pooled, names),
                     time_ids(images.shape[1], images.shape[2],
                              2 * len(names), dev))
        return idx, rows(contexts, names), control[idx], added

    b_a, b_k = len(ANCHOR_NAMES), len(KEY_NAMES)
    rows_a = {n: (i, b_a + i) for i, n in enumerate(ANCHOR_NAMES)}
    # the dense phase reads cat(anchor cache, key cache)
    rows_comb = {**rows_a, **{n: (2 * b_a + j, 2 * b_a + b_k + j)
                              for j, n in enumerate(KEY_NAMES)}}
    anchors, keys = batch(ANCHOR_NAMES), batch(KEY_NAMES)
    key_src = _rows([ANCHOR_OF_KEY[n] for n in KEY_NAMES], rows_a)
    # each dense group's views split over the ranks; `mine`: the views
    # whose latents this rank contributes to the gather
    mine = torch.zeros(n_views, dtype=torch.bool, device=dev)
    mine[torch.cat([anchors[0], keys[0]])] = is_main(group)
    dense = []
    for w, names in dense_groups(dense_batch):
        names = names[slice(*row_span(group, len(names)))]
        if names:
            dense.append((
                dict(w_l=w[0], w_r=w[1], lambda_self=lambda_self),
                batch(names),
                _rows([KEY_VIEW_NAME_PAIR[n][0] for n in names], rows_comb),
                _rows([KEY_VIEW_NAME_PAIR[n][1] for n in names], rows_comb)))
            mine[dense[-1][1][0]] = True

    for t, tp in zip(steps, prevs):
        idx, ctx, ctrl, added = anchors
        lat[idx], cache_a = run(lat[idx], t, tp, ctx, ctrl, "store",
                                added_cond=added)
        note("anchors")
        idx, ctx, ctrl, added = keys
        lat[idx], cache_k = run(lat[idx], t, tp, ctx, ctrl, "key",
                                [c[key_src] for c in cache_a],
                                added_cond=added)
        note("keys")
        comb = [torch.cat([a, k]) for a, k in zip(cache_a, cache_k)]
        cache_a = cache_k = None  # one step's states alive at a time
        for weights, (idx, ctx, ctrl, added), src_l, src_r in dense:
            lat[idx], _ = run(lat[idx], t, tp, ctx, ctrl, "dense",
                              ([c[src_l] for c in comb],
                               [c[src_r] for c in comb]), weights, added)
            note("dense")
        comb = None
    if group is not None:
        lat = all_sum(group, torch.where(mine[:, None, None, None], lat, 0))
    out = gather_rows(group, vae_decode(models.vae, lat[lo:hi]), n_views)
    note("decode")
    return out


def crop_and_downsample(images):
    """[N, 1024, 1024, 3] -> [N, 415, 290, 3] stage-3 targets: the crop,
    then x0.5 with the antialiased linear resize (jax.image.resize
    "linear")."""
    c = images[:, CROP_Y[0]:CROP_Y[1], CROP_X[0]:CROP_X[1], :]
    h, w = c.shape[1] // 2, c.shape[2] // 2
    return linear_resize(c.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)


@torch.no_grad()
def render_refine_views(gaussians, orbit, skel_points3d, height: int,
                        width: int, render_cfg):
    """The handoff's views: the orbit rendered on a black background in
    sweeps of RENDER_BATCH views, with their OpenPose maps. -> (images,
    pose maps), both [N, H, W, 3] float32 in [0, 1]."""
    from ..data.cameras import camera_from_c2w
    from ..render.render import render

    dev = gaussians.device
    points3d = torch.as_tensor(np.asarray(skel_points3d, np.float32),
                               device=dev)
    bg = torch.zeros(3, device=dev)
    head_zoom = (orbit.center_z == HEAD_OFFSET) & (orbit.azimuth_deg > 0)
    rgb, poses = [], []
    for i in range(0, orbit.c2w.shape[0], RENDER_BATCH):
        s = slice(i, i + RENDER_BATCH)
        cams = camera_from_c2w(orbit.c2w[s], orbit.fovy[s], height, width)
        rgb.append(render(gaussians, cams, bg, render_cfg).rgb)
        poses.append(openpose_draw(points3d, orbit.mvp_mtx[s],
                                   orbit.azimuth_deg[s], head_zoom[s],
                                   height, width)[0])
    return torch.cat(rgb), torch.cat(poses)


def refine_contexts(text_encoder, prompt: str, ip_cond, ip_uncond,
                    device="cuda") -> dict:
    """Each view's [2, S + T_ip, D] (negative, positive) context: the
    negative prompt with `ip_uncond` [T_ip, D], the prompt with the view's
    suffix with `ip_cond` (tensors or numpy). text_encoder: list of prompts
    -> [n, S, D] numpy."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    neg = torch.cat([f32(text_encoder([REFINE_NEGATIVE_PROMPT])[0]),
                     f32(ip_uncond)])
    return {name: torch.stack([neg, torch.cat([
        f32(text_encoder([prompt + PROMPT_SUFFIX.get(name, "")])[0]),
        f32(ip_cond)])]) for name in VIEW_NAME_ALL}


def refine_identity_tokens(proj_model, id_embed, clip_hidden,
                           zero_clip_hidden):
    """Stage 2's identity tokens (ProjPlusModel at s_scale 0.5 with the
    shortcut): the positive face for the cond row, the zero face for the
    uncond row. -> (ip_cond, ip_uncond), each [T_ip, D]."""
    from ..guidance.ipa import compute_image_embeds

    emb = compute_image_embeds(proj_model, id_embed,
                               torch.zeros_like(id_embed), clip_hidden,
                               zero_clip_hidden, zero_clip_hidden,
                               s_scale=0.5, shortcut=True)
    return emb.pos[0], emb.neg[0]
