"""The port's diffusion stack against the JAX package on the CPU at tiny
sizes, float32: group_norm, timestep_embedding, ResnetBlock, Attention
(IP tokens and LoRA), the tiny UNet with ControlNet residuals, the tiny
ControlNet, the VAE and the DDIM scheduler. Every flax parameter is drawn
at random from a seed (zero-convs and lora_up included) and carried over
with from_flax; inputs are numpy, NHWC on the JAX side, NCHW on the port's.

Tolerances: outputs within 1e-4 of the output's largest |value|,
gradients within 1e-3 of the largest gradient (f32 sums in another
order, and attention / GroupNorm statistics computed another way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_rel_close, n, nchw, nhwc,
                           random_flax_params, t)

torch.set_num_threads(1)
OUT_TOL = 1e-4
GRAD_TOL = 1e-3


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(0, 1, shape)).astype(np.float32)


@pytest.mark.parametrize("groups, eps", [(8, 1e-5), (4, 1e-6)])
def test_group_norm_forward_and_grads(rng, groups, eps):
    from gaussianip_tpu.diffusion.norm import group_norm as jgn
    from gaussianip_tpu_torch.diffusion.norm import group_norm

    x = _normal(rng, 2, 6, 5, 32) + 0.5
    gamma = 1 + _normal(rng, 32, scale=0.1)
    beta = _normal(rng, 32, scale=0.1)
    dy = _normal(rng, 2, 6, 5, 32)
    f = lambda x, g, b: jnp.sum(jgn(x, g, b, groups, eps) * dy)
    ref = jgn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups,
              eps)
    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                                        jnp.asarray(beta))
    xt, gt, bt = (t(a).requires_grad_(True) for a in (x, gamma, beta))
    y = group_norm(xt.permute(0, 3, 1, 2), gt, bt, groups, eps)
    assert_rel_close(nhwc(y), ref, OUT_TOL, "y")
    (y * nchw(dy)).sum().backward()
    for got, r, what in ((xt.grad, jg[0], "dx"), (gt.grad, jg[1], "dgamma"),
                         (bt.grad, jg[2], "dbeta")):
        assert_rel_close(got, r, GRAD_TOL, what)


def test_timestep_embedding():
    from gaussianip_tpu.diffusion.blocks import timestep_embedding as jte
    from gaussianip_tpu_torch.diffusion.blocks import timestep_embedding

    ts = np.array([0, 1, 37, 500, 999], np.int32)
    for dim in (32, 320):
        assert_rel_close(timestep_embedding(t(ts), dim),
                         jte(jnp.asarray(ts), dim), OUT_TOL, str(dim))


def test_resnet_block(rng):
    from gaussianip_tpu.diffusion.blocks import ResnetBlock as JRes
    from gaussianip_tpu_torch.diffusion.blocks import ResnetBlock
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax

    x = _normal(rng, 2, 8, 8, 16)
    temb = _normal(rng, 2, 24)
    jm = JRes(32, groups=8)
    p = random_flax_params(jm, rng, x, temb)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(temb))
    m = from_flax(ResnetBlock(16, 32, 24, groups=8), p)
    assert_rel_close(nhwc(m(nchw(x), t(temb))), ref, OUT_TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_ip_tokens_and_lora(rng, cross):
    """Self-attention, and cross-attention over 6 text + 4 IP tokens, both
    with rank-4 LoRA on q/k/v/out."""
    from gaussianip_tpu.diffusion.blocks import Attention as JAttn
    from gaussianip_tpu_torch.diffusion.blocks import Attention
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax

    hs = _normal(rng, 2, 12, 32)
    ctx = _normal(rng, 2, 10, 24) if cross else None
    kw = dict(cross_attention_dim=24, ip_tokens=4) if cross else {}
    jm = JAttn(32, 4, lora_rank=4, **kw)
    p = random_flax_params(jm, rng, hs, ctx, ip_scale=0.7)
    ref, _ = jm.apply(p, jnp.asarray(hs),
                      None if ctx is None else jnp.asarray(ctx), ip_scale=0.7)
    m = from_flax(Attention(32, 4, 24 if cross else None, lora_rank=4,
                            ip_tokens=4 if cross else 0), p)
    got = m(t(hs), None if ctx is None else t(ctx), ip_scale=0.7)
    assert_rel_close(got, ref, OUT_TOL)


@pytest.fixture(scope="module")
def unet_pair():
    from gaussianip_tpu.diffusion.unet import (
        ControlNetModel as JCN, UNet2DConditionModel as JUNet,
        tiny_unet_config as jtiny)
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.unet import (
        ControlNetModel, UNet2DConditionModel, tiny_unet_config)

    rng = np.random.default_rng(7)
    lat = _normal(rng, 2, 16, 16, 4)
    ts = np.array([10, 700], np.int32)
    ctx = _normal(rng, 2, 81, 32)
    cond = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ju = JUNet(jtiny(ip_tokens=4, lora_rank=4))
    jc = JCN(jtiny(), conditioning_embed_channels=(8, 16))
    up = random_flax_params(ju, rng, lat, ts, ctx)
    cp = random_flax_params(jc, rng, lat, ts, ctx, cond)
    u = from_flax(UNet2DConditionModel(tiny_unet_config(ip_tokens=4,
                                                        lora_rank=4)), up)
    c = from_flax(ControlNetModel(tiny_unet_config(),
                                  conditioning_embed_channels=(8, 16)), cp)
    return (ju, up, jc, cp), (u, c), (lat, ts, ctx, cond)


def test_controlnet_tiny(unet_pair):
    """All 81 context tokens reach the ControlNet's cross-attention."""
    (_, _, jc, cp), (_, c), (lat, ts, ctx, cond) = unet_pair
    jres, jmid = jc.apply(cp, jnp.asarray(lat), jnp.asarray(ts),
                          jnp.asarray(ctx), jnp.asarray(cond),
                          conditioning_scale=0.8)
    with torch.no_grad():
        res, mid = c(nchw(lat), t(ts), t(ctx), nchw(cond),
                     conditioning_scale=0.8)
    assert len(res) == len(jres)
    for i, (a, b) in enumerate(zip(res, jres)):
        assert_rel_close(nhwc(a), b, OUT_TOL, f"res {i}")
    assert_rel_close(nhwc(mid), jmid, OUT_TOL, "mid")


def test_unet_tiny_with_controlnet_residuals(unet_pair):
    (ju, up, _, _), (u, _), (lat, ts, ctx, _) = unet_pair
    rng = np.random.default_rng(3)
    # residual shapes: the skips of the down path (conv_in, 1 per layer,
    # 1 per downsample) and the mid output
    shapes = [(2, 16, 16, 32), (2, 16, 16, 32), (2, 8, 8, 32),
              (2, 8, 8, 64)]
    res = [_normal(rng, *s, scale=0.3) for s in shapes]
    mid = _normal(rng, 2, 8, 8, 64, scale=0.3)
    ref, _ = ju.apply(up, jnp.asarray(lat), jnp.asarray(ts),
                      jnp.asarray(ctx),
                      down_block_residuals=[jnp.asarray(r) for r in res],
                      mid_block_residual=jnp.asarray(mid), ip_scale=0.5)
    with torch.no_grad():
        got = u(nchw(lat), t(ts), t(ctx),
                down_block_residuals=[nchw(r) for r in res],
                mid_block_residual=nchw(mid), ip_scale=0.5)
    assert_rel_close(nhwc(got), ref, OUT_TOL)


@pytest.fixture(scope="module")
def vae_pair():
    from gaussianip_tpu.diffusion.vae import (AutoencoderKL as JVAE,
                                              tiny_vae_config as jtiny)
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                    tiny_vae_config)

    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jv = JVAE(jtiny())
    p = random_flax_params(jv, rng, img)
    return jv, p, from_flax(AutoencoderKL(tiny_vae_config()), p), img


def test_vae_encode_moments_and_decode(vae_pair):
    jv, p, v, img = vae_pair
    jmean, jlogvar = jv.apply(p, jnp.asarray(img), method=jv.encode_moments)
    with torch.no_grad():
        mean, logvar = v.encode_moments(nchw(img))
        assert_rel_close(nhwc(mean), jmean, OUT_TOL, "mean")
        assert_rel_close(nhwc(logvar), jlogvar, OUT_TOL, "logvar")
        lat = np.random.default_rng(2).normal(0, 1, (2, 8, 8, 4)).astype(
            np.float32)
        ref = jv.apply(p, jnp.asarray(lat), method=jv.decode)
        assert_rel_close(nhwc(v.decode(nchw(lat))), ref, OUT_TOL, "decode")


def test_vae_encode_with_eps_and_its_gradient(vae_pair):
    """encode with the posterior draw injected (the JAX key's normal draw),
    and d(sum(z * w))/d(images)."""
    jv, p, v, img = vae_pair
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (2, 8, 8, 4)))
    wz = np.random.default_rng(5).normal(0, 1, (2, 8, 8, 4)).astype(
        np.float32)
    f = lambda x: jv.apply(p, x, key, method=jv.encode)
    ref = f(jnp.asarray(img))
    jgrad = jax.grad(lambda x: jnp.sum(f(x) * wz))(jnp.asarray(img))
    x = t(img).requires_grad_(True)
    z = v.encode(x.permute(0, 3, 1, 2), nchw(eps))
    assert_rel_close(nhwc(z), ref, OUT_TOL, "z")
    (z * nchw(wz)).sum().backward()
    assert_rel_close(x.grad, jgrad, GRAD_TOL, "dz/dimages")


def test_scheduler():
    from gaussianip_tpu.diffusion import scheduler as js
    from gaussianip_tpu_torch.diffusion import scheduler as ps

    jsch = js.make_ddim_schedule()
    sch = ps.make_ddim_schedule(device="cpu")
    np.testing.assert_allclose(n(sch.alphas_cumprod),
                               np.asarray(jsch.alphas_cumprod), rtol=1e-5)
    np.testing.assert_allclose(float(sch.final_alpha_cumprod),
                               float(jsch.final_alpha_cumprod), rtol=1e-6)
    rng = np.random.default_rng(9)
    x0 = _normal(rng, 3, 4, 5, 5)
    eps = _normal(rng, 3, 4, 5, 5)
    tt = np.array([0, 480, 999], np.int32)
    prev = np.array([-1, 460, 979], np.int32)
    ref = js.add_noise(jsch, jnp.asarray(x0), jnp.asarray(eps),
                       jnp.asarray(tt))
    assert_rel_close(ps.add_noise(sch, t(x0), t(eps), t(tt).long()), ref,
                     OUT_TOL, "add_noise")
    ref = js.ddim_step(jsch, jnp.asarray(eps), jnp.asarray(tt),
                       jnp.asarray(prev), jnp.asarray(x0))
    got = ps.ddim_step(sch, t(eps), t(tt).long(), t(prev).long(), t(x0))
    assert_rel_close(got, ref, OUT_TOL, "ddim_step")
    np.testing.assert_array_equal(n(ps.refine_timestep_ladder(device="cpu")),
                                  np.asarray(js.refine_timestep_ladder()))


def _flax_shapes(params):
    """{port parameter name: port shape} of a flax shape tree, through the
    same key mapping as from_flax."""
    from gaussianip_tpu_torch.diffusion.from_flax import torch_key

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            params["params"])[0]:
        name, perm = torch_key(tuple(str(p.key) for p in path),
                               len(leaf.shape))
        shape = tuple(leaf.shape)
        out[name] = shape if perm is None else tuple(shape[i] for i in perm)
    return out


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae", "proj"])
def test_full_width_modules_carry_every_flax_param(which):
    """At the recipe's full widths (SD1.5 UNet with 4 IP tokens and the
    LoRA folded, ControlNet, SD VAE, ProjPlusModel), the port's parameter
    names and shapes are exactly the flax tree's under from_flax's
    mapping (flax shapes from jax.eval_shape, port modules on the meta
    device); the UNet has 47 and the ControlNet 20 stride-1 Conv3x3
    sites, K3's launches per pass."""
    from gaussianip_tpu.diffusion import ip_adapter as jip
    from gaussianip_tpu.diffusion import unet as ju
    from gaussianip_tpu.diffusion import vae as jv
    from gaussianip_tpu_torch.diffusion import ip_adapter, unet, vae
    from gaussianip_tpu_torch.ops.conv3x3 import Conv3x3
    from gaussianip_tpu_torch.system.pipeline import sd15_unet_config

    key = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, 8, 8, 4))
    ts = jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 81, 768))
    jcfg = lambda ip: ju.UNetConfig(lora_rank=0, ip_tokens=ip)
    flax_mod, args, port_ctor, sites = {
        "unet": (ju.UNet2DConditionModel(jcfg(4)), (lat, ts, ctx),
                 lambda: unet.UNet2DConditionModel(sd15_unet_config()), 47),
        "controlnet": (ju.ControlNetModel(jcfg(0)),
                       (lat, ts, ctx, jnp.zeros((1, 64, 64, 3))),
                       lambda: unet.ControlNetModel(
                           sd15_unet_config(ip_tokens=0)), 20),
        "vae": (jv.AutoencoderKL(jv.VAEConfig()),
                (jnp.zeros((1, 64, 64, 3)),),
                lambda: vae.AutoencoderKL(vae.VAEConfig()), 0),
        "proj": (jip.ProjPlusModel(),
                 (jnp.zeros((1, 512)), jnp.zeros((1, 257, 1280))),
                 lambda: ip_adapter.ProjPlusModel(), 0),
    }[which]
    want = _flax_shapes(jax.eval_shape(lambda: flax_mod.init(key, *args)))
    with torch.device("meta"):
        m = port_ctor()
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    assert sum(isinstance(c, Conv3x3) and c.stride == 1
               for c in m.modules()) == sites
