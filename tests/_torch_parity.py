"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
numpy <-> torch conversion and one scene built identically in both
packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    a = np.array(x)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def n(x):
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def nchw(x):
    """NHWC numpy / jax array -> NCHW torch tensor (a channels_last view)."""
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW torch tensor -> NHWC numpy."""
    return n(x.permute(0, 2, 3, 1))


def assert_rel_close(got, ref, tol, what=""):
    """max |got - ref| <= tol * max |ref|."""
    got, ref = np.asarray(n(got), np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def random_flax_params(module, rng, *args, method=None, **kwargs):
    """Every leaf of `module`'s param tree drawn from `rng`: kernels
    N(0, 1/fan_in) (zero-init convs and lora_up included), norm scales
    1 + N(0, 0.1), biases and other leaves N(0, 0.1). Shapes come from
    jax.eval_shape of init, so nothing compiles."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, method=method,
                               **kwargs), *args)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_state_numpy(js) -> dict:
    """A JAX GaussianState as the numpy dict `state_from_numpy` takes."""
    d = {f: np.asarray(getattr(js, f)) for f in PARAM_FIELDS}
    d.update(n_active=int(js.n_active), max_sh_degree=js.max_sh_degree,
             active_sh_degree=js.active_sh_degree)
    return d


def train_state_numpy(jts) -> dict:
    """A JAX stage-1 TrainState as the numpy dict `train_state_from_numpy`
    takes."""
    return {
        "gaussians": jax_state_numpy(jts.gaussians),
        "m": {f: np.asarray(jts.opt.m[f]) for f in PARAM_FIELDS},
        "v": {f: np.asarray(jts.opt.v[f]) for f in PARAM_FIELDS},
        "adam_count": int(jts.opt.count),
        "stats": {f: np.asarray(getattr(jts.stats, f))
                  for f in ("xyz_grad_accum", "denom", "max_radii2d")},
        "step": int(jts.step),
    }


def stage1_scene():
    """(Skeleton, JAX TrainState): 400 points sampled on a synthetic
    SMPL-X body, capacity 1024, the stage-1 parity tests' scene."""
    from gaussianip_tpu.human.skeleton import Skeleton
    from gaussianip_tpu.human.smplx_jax import make_test_model
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.knn import mean_dist2_3nn
    from gaussianip_tpu.system.stage1 import init_train_state

    sk = Skeleton(_test_model=make_test_model(np.random.default_rng(0),
                                              n_verts=300, n_faces=200))
    sk.forward_smplx()
    sk.scale(-10)
    pts = sk.sample_smplx_points(400)
    d2 = mean_dist2_3nn(jnp.asarray(pts), block=128)
    cols = np.random.default_rng(1).uniform(0, 1, (400, 3)).astype(np.float32)
    gs = create_from_pcd(pts, cols, 1024, d2)
    return sk, init_train_state(gs)


def make_states(rng, n_pts=400, capacity=512, opacity=(-2.0, 3.0)):
    """The same random splat scene as a JAX and a torch (CPU) GaussianState:
    points N(0, 0.3), random colours, opacity logits uniform in `opacity`."""
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.knn import mean_dist2_3nn
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy

    pts = rng.normal(0, 0.3, (n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    d2 = mean_dist2_3nn(jnp.asarray(pts), block=256)
    js = create_from_pcd(pts, cols, capacity, d2)
    op = rng.uniform(*opacity, (capacity, 1)).astype(np.float32)
    js = js.replace(opacity=jnp.asarray(op))
    return js, state_from_numpy(jax_state_numpy(js), "cpu")


def make_cameras(b, h, w, dist=2.0):
    """An orbit of b cameras as (JAX Camera batch, torch Camera)."""
    from gaussianip_tpu.data.cameras import camera_from_c2w as jcam
    from gaussianip_tpu.ops.camera_math import look_at_c2w
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w

    az = jnp.linspace(0, 2 * jnp.pi, b, endpoint=False)
    eye = jnp.stack([dist * jnp.cos(az), dist * jnp.sin(az),
                     0.3 * jnp.ones(b)], -1)
    c2w = look_at_c2w(eye, jnp.zeros((b, 3)),
                      jnp.tile(jnp.array([[0.0, 0, 1]]), (b, 1)))
    fovy = jnp.full((b,), 0.9, jnp.float32)
    jc = jax.vmap(lambda m, f: jcam(m, f, h, w))(c2w, fovy)
    return jc, camera_from_c2w(t(c2w), t(fovy), h, w)


def tiny_guidance_pair(rng, image_size: int = 64):
    """The tiny stack of tests/test_guidance_ipa.py (UNet with 4 IP tokens
    and rank-4 LoRA, a 2-level ControlNet, the tiny VAE, fake 77 x 32 text,
    constant identity tokens), with random parameters carried over."""
    from gaussianip_tpu.diffusion.unet import (
        ControlNetModel as JCN, UNet2DConditionModel as JUNet,
        tiny_unet_config as jtiny)
    from gaussianip_tpu.diffusion.vae import (AutoencoderKL as JVAE,
                                              tiny_vae_config as jtvae)
    from gaussianip_tpu.guidance import ipa as jipa
    from gaussianip_tpu.guidance.prompts import (
        fake_text_encoder as jfake, make_prompt_embeddings as jmpe)
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.unet import (
        ControlNetModel, UNet2DConditionModel, tiny_unet_config)
    from gaussianip_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                    tiny_vae_config)
    from gaussianip_tpu_torch.guidance import ipa
    from gaussianip_tpu_torch.guidance.prompts import (
        fake_text_encoder, make_prompt_embeddings)

    lat = np.zeros((1, image_size // 2, image_size // 2, 4), np.float32)
    ts = np.array([1], np.int32)
    ctx = np.zeros((1, 81, 32), np.float32)
    img = np.zeros((1, image_size, image_size, 3), np.float32)
    ju = JUNet(jtiny(ip_tokens=4, lora_rank=4))
    jc = JCN(jtiny(ip_tokens=4, lora_rank=4),
             conditioning_embed_channels=(8, 16))
    jv = JVAE(jtvae())
    up = random_flax_params(ju, rng, lat, ts, ctx)
    cp = random_flax_params(jc, rng, lat, ts, ctx[:, :77], img)
    vp = random_flax_params(jv, rng, img)
    jg = jipa.AHDSGuidance(
        jipa.GuidanceModels(ju, up, jc, cp, jv, vp),
        jmpe(jfake(77, 32), "a person", "bad quality", ""),
        jipa.ImageEmbeds(pos=jnp.ones((1, 4, 32)) * 0.01,
                         null=jnp.zeros((1, 4, 32)),
                         neg=jnp.zeros((1, 4, 32))),
        # latent_size as tests/test_guidance_ipa.py: never read
        jipa.GuidanceConfig(latent_size=8, image_size=image_size))
    models = ipa.GuidanceModels(
        from_flax(UNet2DConditionModel(tiny_unet_config(ip_tokens=4,
                                                        lora_rank=4)), up),
        from_flax(ControlNetModel(tiny_unet_config(ip_tokens=4,
                                                   lora_rank=4),
                                  conditioning_embed_channels=(8, 16)), cp),
        from_flax(AutoencoderKL(tiny_vae_config()), vp))
    g = ipa.AHDSGuidance(
        models, make_prompt_embeddings(fake_text_encoder(77, 32), "a person",
                                       "bad quality", "", device="cpu"),
        ipa.ImageEmbeds(pos=torch.full((1, 4, 32), 0.01),
                        null=torch.zeros((1, 4, 32)),
                        neg=torch.zeros((1, 4, 32))),
        ipa.GuidanceConfig(image_size=image_size))
    return jg, g


def jax_draws(key, b, latent_hw=32):
    """The port's draws from the JAX guidance's own split of `key`
    (guidance/ipa.py: k_t, k_noise, k_vae = split(key, 3))."""
    k_t, k_noise, k_vae = jax.random.split(key, 3)
    shape = (b, latent_hw, latent_hw, 4)
    return {"u": t(jax.random.randint(k_t, (b,), 0, 1 << 30)),
            "noise": nchw(jax.random.normal(k_noise, shape)),
            "eps": nchw(jax.random.normal(k_vae, shape))}
