"""Stage 2 of the port (the VCR attention modes, the UNet's VCR plumbing,
system/refine.py and the handoff) against the JAX package on the CPU at
tiny sizes, float32, on the same numpy inputs; flax parameters are drawn
at random and carried over with from_flax. The shared refine noise comes
from the JAX key's split and goes into the port as an argument.

Tolerances: attention and UNet outputs within 1e-4 of the output's
largest |value| (f32 sums in another order); the VCR caches are the same
LayerNorm outputs, within 1e-5; a DDIM step's latents within 1e-4; the
whole refine (VAE encode, 8 denoise calls, VAE decode) within 1e-4
absolute on images in [0, 1]; the orbit and the crop-and-resize within
1e-5 absolute; the handoff's renders within 1e-4 absolute, its pose maps
as tests/test_torch_human.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_rel_close, n, nchw, nhwc,
                           random_flax_params, t, tiny_guidance_pair)

torch.set_num_threads(1)
OUT_TOL = 1e-4
IMG = 16  # the tiny VAE halves it: 8 x 8 latents


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(0, 1, shape)).astype(np.float32)


def _vcr_ops(rng, mode, b, s, d):
    """The same VCR op for both packages: (JAX op, port op)."""
    if mode == "store":
        return {"mode": "store"}, {"mode": "store"}
    if mode == "key":
        src = _normal(rng, b, s + 3, d)
        return ({"mode": "key", "src": jnp.asarray(src)},
                {"mode": "key", "src": t(src)})
    src_l, src_r = _normal(rng, b, s, d), _normal(rng, b, s, d)
    w = {"w_l": 0.25, "w_r": 0.75, "lambda_self": 0.55}
    return ({"mode": "dense", "src_l": jnp.asarray(src_l),
             "src_r": jnp.asarray(src_r), **w},
            {"mode": "dense", "src_l": t(src_l), "src_r": t(src_r), **w})


@pytest.mark.parametrize("mode", ["store", "key", "dense"])
def test_vcr_attention_modes(rng, mode):
    """Self-attention with rank-4 LoRA in each VCR mode; in store / key
    mode the JAX layer stores the hidden states it received."""
    from gaussianip_tpu.diffusion.blocks import Attention as JAttn
    from gaussianip_tpu_torch.diffusion.blocks import Attention
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax

    hs = _normal(rng, 2, 12, 32)
    jop, op = _vcr_ops(rng, mode, 2, 12, 32)
    jm = JAttn(32, 4, lora_rank=4)
    p = random_flax_params(jm, rng, hs, vcr=jop)
    ref, stored = jm.apply(p, jnp.asarray(hs), vcr=jop)
    m = from_flax(Attention(32, 4, lora_rank=4), p)
    assert_rel_close(m(t(hs), vcr=op), ref, OUT_TOL, mode)
    if mode == "dense":
        assert stored is None
    else:
        np.testing.assert_array_equal(np.asarray(stored), hs)


@pytest.mark.parametrize("mode", ["off", "store", "key", "dense"])
def test_transformer2d_vcr(rng, mode):
    """Transformer2D with two blocks: the op reaches the first block only,
    and store / key return that block's norm1 output."""
    from gaussianip_tpu.diffusion.blocks import Transformer2D as JT
    from gaussianip_tpu_torch.diffusion.blocks import Transformer2D
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax

    x = _normal(rng, 2, 4, 4, 32)
    ctx = _normal(rng, 2, 10, 24)
    jop, op = (None, None) if mode == "off" else _vcr_ops(rng, mode, 2, 16,
                                                          32)
    jm = JT(32, 4, 24, n_blocks=2, lora_rank=4, ip_tokens=4, groups=8)
    p = random_flax_params(jm, rng, x, ctx, ip_scale=0.6, vcr=jop)
    ref, jstored = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx),
                            ip_scale=0.6, vcr=jop)
    m = from_flax(Transformer2D(32, 4, 24, n_blocks=2, lora_rank=4,
                                ip_tokens=4, groups=8), p)
    got, stored = m(nchw(x), t(ctx), 0.6, op)
    assert_rel_close(nhwc(got), ref, OUT_TOL, mode)
    if jstored is None:
        assert stored is None
    else:
        assert_rel_close(stored, jstored, 1e-5, "stored")


@pytest.fixture(scope="module")
def unet_pair():
    from gaussianip_tpu.diffusion.unet import (UNet2DConditionModel as JUNet,
                                               tiny_unet_config as jtiny)
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.unet import (UNet2DConditionModel,
                                                     tiny_unet_config)

    rng = np.random.default_rng(11)
    lat = _normal(rng, 2, 8, 8, 4)
    ts = np.array([40, 600], np.int32)
    ctx = _normal(rng, 2, 81, 32)
    ju = JUNet(jtiny(ip_tokens=4, lora_rank=4))
    up = random_flax_params(ju, rng, lat, ts, ctx)
    u = from_flax(UNet2DConditionModel(tiny_unet_config(ip_tokens=4,
                                                        lora_rank=4)), up)
    return ju, up, u, (lat, ts, ctx)


@pytest.mark.parametrize("mode", ["store", "key", "dense"])
def test_unet_vcr_modes(unet_pair, rng, mode):
    """The tiny UNet (2 VCR layers at 8 x 8, width 32) in each mode: the
    noise prediction, and in store / key mode the stored states in layer
    order; key mode reads one source per layer, dense a (left, right)
    pair."""
    ju, up, u, (lat, ts, ctx) = unet_pair
    assert u.cfg.n_vcr_layers == 2
    srcs = [[_normal(rng, 2, 64, 32) for _ in range(2)] for _ in range(2)]
    jcache = tcache = weights = None
    if mode == "key":
        jcache = [jnp.asarray(s) for s in srcs[0]]
        tcache = [t(s) for s in srcs[0]]
    elif mode == "dense":
        jcache = tuple([jnp.asarray(s) for s in side] for side in srcs)
        tcache = tuple([t(s) for s in side] for side in srcs)
        weights = {"w_l": 0.75, "w_r": 0.25, "lambda_self": 0.55}
    ref, jstored = ju.apply(up, jnp.asarray(lat), jnp.asarray(ts),
                            jnp.asarray(ctx), ip_scale=0.6, vcr_mode=mode,
                            vcr_cache=jcache, vcr_weights=weights)
    with torch.no_grad():
        got, stored = u(nchw(lat), t(ts), t(ctx), ip_scale=0.6,
                        vcr_mode=mode, vcr_cache=tcache, vcr_weights=weights)
    assert_rel_close(nhwc(got), ref, OUT_TOL, mode)
    if mode == "dense":
        assert stored is None and jstored is None
    else:
        assert len(stored) == len(jstored) == 2
        for i, (a, b) in enumerate(zip(stored, jstored)):
            assert_rel_close(a, b, 1e-5, f"cache {i}")


@pytest.fixture(scope="module")
def refine_pair():
    """The tiny stack of the stage-1 guidance tests as stage 2's models
    (UNet with 4 IP tokens and rank-4 LoRA, ControlNet, VAE), 32 views of
    16 x 16 images and pose maps, and each view's (negative, positive)
    context of 77 text + 4 identity tokens."""
    from gaussianip_tpu.system import refine as jr
    from gaussianip_tpu_torch.system import refine as pr

    rng = np.random.default_rng(5)
    jg, g = tiny_guidance_pair(rng, image_size=IMG)
    imgs = rng.uniform(0, 1, (32, IMG, IMG, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 1, (32, IMG, IMG, 3)).astype(np.float32)
    ctxs = {v: _normal(rng, 2, 81, 32, scale=0.5) for v in jr.VIEW_NAME_ALL}
    return ((jr.RefineModels(*jg.models), pr.RefineModels(*g.models)),
            (imgs, ctrl, ctxs))


@pytest.mark.parametrize("mode", ["store", "key", "dense"])
def test_refine_step_phases(refine_pair, rng, mode):
    """One DDIM step of make_refine_step per phase on a 4-view batch (8
    CFG rows, uncond first): latents and the stored cache."""
    from gaussianip_tpu.diffusion.scheduler import make_ddim_schedule as jdd
    from gaussianip_tpu.system.refine import make_refine_step as jmake
    from gaussianip_tpu_torch.diffusion.scheduler import make_ddim_schedule
    from gaussianip_tpu_torch.system.refine import make_refine_step

    (jm, pm), (_, ctrl, _) = refine_pair
    lat = _normal(rng, 4, IMG // 2, IMG // 2, 4)
    ctx = _normal(rng, 8, 81, 32, scale=0.5)
    srcs = [[_normal(rng, 8, 64, 32) for _ in range(2)] for _ in range(2)]
    jcache = tcache = weights = None
    if mode == "key":
        jcache = [jnp.asarray(s) for s in srcs[0]]
        tcache = [t(s) for s in srcs[0]]
    elif mode == "dense":
        jcache = tuple([jnp.asarray(s) for s in side] for side in srcs)
        tcache = tuple([t(s) for s in side] for side in srcs)
        weights = {"w_l": 0.5, "w_r": 0.5, "lambda_self": 0.55}
    jrun = jmake(jm, jdd(), 7.5, 0.6)
    ref, jstored = jrun(jnp.asarray(lat), 143, 122, jnp.asarray(ctx),
                        jnp.asarray(ctrl[:4]), vcr_mode=mode,
                        vcr_cache=jcache, vcr_weights=weights)
    run = make_refine_step(pm, make_ddim_schedule(device="cpu"), 7.5, 0.6)
    got, stored = run(nchw(lat), 143, 122, t(ctx), nchw(ctrl[:4]), mode,
                      tcache, weights)
    assert_rel_close(nhwc(got), ref, OUT_TOL, "latents")
    if mode == "dense":
        assert stored is None and jstored is None
    else:
        for a, b in zip(stored, jstored):
            assert_rel_close(a, b, 1e-5, "cache")


def test_refine_views_tiny_matches_jax(refine_pair):
    """The whole refine on 32 views at num_steps 1 (anchors, keys, 6 dense
    groups of 4), the shared noise from the JAX key's split."""
    from gaussianip_tpu.system.refine import refine_views as jrefine
    from gaussianip_tpu_torch.system.refine import refine_views

    (jm, pm), (imgs, ctrl, ctxs) = refine_pair
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jrefine(jm, jnp.asarray(imgs), jnp.asarray(ctrl),
                             {k: jnp.asarray(v) for k, v in ctxs.items()},
                             key, num_steps=1))
    k_noise, _ = jax.random.split(key)
    noise = jax.random.normal(k_noise, (IMG // 2, IMG // 2, 4))
    phases = []
    got = refine_views(pm, t(imgs), t(ctrl),
                       {k: t(v) for k, v in ctxs.items()},
                       t(noise).permute(2, 0, 1), num_steps=1,
                       on_phase=phases.append)
    assert phases == ["encode", "anchors", "keys"] + ["dense"] * 6 + [
        "decode"]
    assert got.shape == (32, IMG, IMG, 3)
    # the comparison is not decided by the clamp alone
    assert ((ref > 0) & (ref < 1)).mean() > 0.2
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=1e-4)


def test_view_topology_and_dense_groups():
    from gaussianip_tpu.system import refine as jr
    from gaussianip_tpu_torch.system import refine as pr

    for name in ("VIEW_IDX_ALL", "VIEW_NAME_ALL", "PROMPT_SUFFIX",
                 "REFINE_NEGATIVE_PROMPT", "KEY_VIEW_NAME_PAIR",
                 "KEY_VIEW_WEIGHT_PAIR", "ANCHOR_OF_KEY", "LAMBDA_SELF",
                 "NUM_REFINE_STEPS", "CROP_X", "CROP_Y"):
        assert getattr(pr, name) == getattr(jr, name), name
    groups = pr.dense_groups(4)
    assert [w for w, _ in groups] == [(0.75, 0.25)] * 2 + [(0.5, 0.5)] * 2 \
        + [(0.25, 0.75)] * 2
    assert sorted(v for _, g in groups for v in g) == sorted(
        f"v{i}" for i in range(24))


def test_refine_orbit_batch():
    from gaussianip_tpu.data.sampler import refine_orbit_batch as jorbit
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch

    ref = jorbit(32, 17.0, 1.5, 70.0, 1024, 1024)
    got = refine_orbit_batch(32, 17.0, 1.5, 70.0, 1024, 1024, device="cpu")
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_crop_and_downsample(rng):
    """[2, 1024, 1024, 3] -> [2, 415, 290, 3] against jax.image.resize's
    antialiased linear shrink."""
    from gaussianip_tpu.system.refine import crop_and_downsample as jcrop
    from gaussianip_tpu_torch.system.refine import crop_and_downsample

    x = rng.uniform(0, 1, (2, 1024, 1024, 3)).astype(np.float32)
    ref = np.asarray(jcrop(jnp.asarray(x)))
    got = crop_and_downsample(t(x))
    assert got.shape == ref.shape == (2, 415, 290, 3)
    np.testing.assert_allclose(n(got), ref, rtol=0, atol=1e-5)


def test_refine_contexts_and_identity_tokens(rng):
    """Each view's (negative, positive) context as launch.py builds it,
    and the identity rows of a ProjPlusModel at s_scale 0.5 with the
    shortcut: the positive face for the cond row, the zero face for the
    uncond row."""
    from gaussianip_tpu.diffusion.ip_adapter import ProjPlusModel as JProj
    from gaussianip_tpu.guidance.ipa import compute_image_embeds as jcie
    from gaussianip_tpu.guidance.prompts import fake_text_encoder as jfake
    from gaussianip_tpu.system.refine import (PROMPT_SUFFIX,
                                              REFINE_NEGATIVE_PROMPT,
                                              VIEW_NAME_ALL)
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.guidance.prompts import fake_text_encoder
    from gaussianip_tpu_torch.system.refine import (refine_contexts,
                                                    refine_identity_tokens)

    ide = _normal(rng, 1, 512)
    clip = _normal(rng, 1, 257, 1280)
    zclip = _normal(rng, 1, 257, 1280)
    jp = JProj()
    pp = random_flax_params(jp, rng, jnp.asarray(ide), jnp.asarray(clip))
    emb = jcie(jp, pp, jnp.asarray(ide), jnp.zeros_like(jnp.asarray(ide)),
               jnp.asarray(clip), jnp.asarray(zclip), jnp.asarray(zclip),
               s_scale=0.5, shortcut=True)
    ip_cond, ip_uncond = refine_identity_tokens(
        from_flax(ProjPlusModel(), pp), t(ide), t(clip), t(zclip))
    assert_rel_close(ip_cond, emb.pos[0], OUT_TOL, "cond")
    assert_rel_close(ip_uncond, emb.neg[0], OUT_TOL, "uncond")

    enc = jfake(77, 768)
    ctxs = refine_contexts(fake_text_encoder(77, 768), "a person",
                           n(ip_cond), n(ip_uncond), device="cpu")
    assert sorted(ctxs) == sorted(VIEW_NAME_ALL)
    for name in VIEW_NAME_ALL:  # launch.py's construction
        pos = np.concatenate([enc(["a person" + PROMPT_SUFFIX.get(name, "")])
                              [0], n(ip_cond)])
        neg = np.concatenate([enc([REFINE_NEGATIVE_PROMPT])[0],
                              n(ip_uncond)])
        np.testing.assert_array_equal(n(ctxs[name]), np.stack([neg, pos]))


def test_render_refine_views_matches_launch():
    """The handoff's renders and pose maps against the JAX package's
    render (dense reference compositor on both sides) and openpose_draw,
    as launch.py makes them: 8 orbit views at 32^2 in sweeps of 4."""
    from _torch_parity import make_states
    from gaussianip_tpu.data.cameras import camera_from_c2w as jcam
    from gaussianip_tpu.data.sampler import refine_orbit_batch as jorbit
    from gaussianip_tpu.human.posemap import openpose_draw as jdraw
    from gaussianip_tpu.render.render import RenderConfig as JRC
    from gaussianip_tpu.render.render import render as jrender
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.refine import render_refine_views

    js, gs = make_states(np.random.default_rng(2), n_pts=300, capacity=512)
    pts3d = np.random.default_rng(4).normal(0, 0.3, (18, 3)).astype(
        np.float32)
    orbit = jorbit(8, 17.0, 1.5, 70.0, 32, 32)
    cams = jax.vmap(lambda m, f: jcam(m, f, 32, 32))(orbit.c2w, orbit.fovy)
    ref = np.asarray(jrender(js, cams, jnp.zeros(3),
                             JRC(backend="reference")).rgb)
    head_zoom = (orbit.center_z == 0.65) & (orbit.azimuth_deg > 0)
    poses, _, _ = jax.vmap(lambda m, a, hz: jdraw(
        jnp.asarray(pts3d), m, a, hz, 32, 32))(orbit.mvp_mtx,
                                                orbit.azimuth_deg, head_zoom)
    rgb, pose = render_refine_views(
        gs, refine_orbit_batch(8, 17.0, 1.5, 70.0, 32, 32, device="cpu"),
        pts3d, 32, 32, RenderConfig(backend="reference"))
    assert rgb.shape == pose.shape == (8, 32, 32, 3)
    assert ref.max() > 0.1
    np.testing.assert_allclose(n(rgb), ref, rtol=0, atol=1e-4)
    # as tests/test_torch_human.py: pixels on a circle's or limb's edge may
    # flip in the analytic raster, at most 1 in 1000
    diff = np.abs(n(pose) - np.asarray(poses)).max(axis=-1)
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).mean()


def test_random_refine_contexts_full_width():
    """The full-width stage-2 contexts of the random stack: [2, 81, 768]
    per view, the 4 identity tokens of a row the same in every view, the
    negative row's text the same in every view, tensors on the device
    asked for."""
    from gaussianip_tpu_torch.system.pipeline import random_refine_contexts
    from gaussianip_tpu_torch.system.refine import VIEW_NAME_ALL

    ctxs = random_refine_contexts(0, device="cpu")
    assert sorted(ctxs) == sorted(VIEW_NAME_ALL)
    front = ctxs["front"]
    assert front.shape == (2, 81, 768) and front.dtype == torch.float32
    assert bool(torch.isfinite(front).all())
    for c in ctxs.values():
        assert torch.equal(c[0], front[0])
        assert torch.equal(c[1, 77:], front[1, 77:])
    assert not torch.equal(ctxs["back"][1, :77], front[1, :77])
    assert not torch.equal(front[0, 77:], front[1, 77:])
