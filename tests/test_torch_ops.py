"""Parity of the port's math ops, cameras, sampler and k-NN with the JAX
package on identical inputs. Tolerance: 1e-5 relative (both f32; the ops
are the same formulas, so only rounding order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(rng, deg):
    from gaussianip_tpu.ops import sh as jsh
    from gaussianip_tpu_torch.ops import sh

    k = (deg + 1) ** 2
    coeffs = rng.normal(0, 1, (64, 3, k)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    close(sh.eval_sh(deg, t(coeffs), t(dirs)),
          jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    rgb = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    close(sh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def test_transforms(rng):
    from gaussianip_tpu.ops import transforms as jtr
    from gaussianip_tpu_torch.ops import transforms as tr

    q = rng.normal(0, 1, (32, 4)).astype(np.float32)
    close(tr.quat_to_rotmat(t(q)), jtr.quat_to_rotmat(jnp.asarray(q)))
    x = rng.uniform(0.01, 0.99, (32,)).astype(np.float32)
    close(tr.inverse_sigmoid(t(x)), jtr.inverse_sigmoid(jnp.asarray(x)))
    for step in (0, 1, 700, 30_000, 40_000):
        close(tr.expon_lr(step, 2e-4, 1e-4, max_steps=30_000),
              jtr.expon_lr(step, 2e-4, 1e-4, max_steps=30_000))


def test_camera_math(rng):
    from gaussianip_tpu.data.cameras import camera_from_c2w as jcam
    from gaussianip_tpu.ops import camera_math as jcm
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.ops import camera_math as cm

    b = 5
    el = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    az = rng.uniform(-3, 3, b).astype(np.float32)
    d = rng.uniform(1.0, 2.0, b).astype(np.float32)
    pos_j = jcm.spherical_to_position(jnp.asarray(el), jnp.asarray(az),
                                      jnp.asarray(d))
    pos = cm.spherical_to_position(t(el), t(az), t(d))
    close(pos, pos_j)
    up = np.tile(np.array([[0.0, 0, 1]], np.float32), (b, 1))
    center = rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    c2w_j = jcm.look_at_c2w(pos_j, jnp.asarray(center), jnp.asarray(up))
    c2w = cm.look_at_c2w(pos, t(center), t(up))
    close(c2w, c2w_j)
    fovy = rng.uniform(0.6, 1.2, b).astype(np.float32)
    proj_j = jcm.gl_projection_matrix(jnp.asarray(fovy), 1.25, 0.1, 1000.0)
    proj = cm.gl_projection_matrix(t(fovy), 1.25, 0.1, 1000.0)
    close(proj, proj_j)
    close(cm.get_mvp_matrix(c2w, proj), jcm.get_mvp_matrix(c2w_j, proj_j),
          atol=1e-5)
    # splat cameras: the port batches what the JAX package vmaps
    jc = jax.vmap(lambda m, f: jcam(m, f, 40, 56))(c2w_j, jnp.asarray(fovy))
    cam = camera_from_c2w(c2w, t(fovy), 40, 56)
    for f in ("world_view_t", "full_proj_t", "camera_center", "fovx", "fovy"):
        close(getattr(cam, f), getattr(jc, f), atol=1e-5)


@pytest.mark.parametrize("step", [0, 1500])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_sample_train_batch_injected(step, seed):
    """The JAX sampler's own uniforms, handed to the port's geometry."""
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCfg
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu_torch.data.sampler import (CameraDraws,
                                                   CameraSamplerConfig,
                                                   train_batch_from_draws)

    kw = dict(height=40, width=56, batch_size=3, head_prob=0.5,
              back_prob=0.5)
    key = jax.random.PRNGKey(seed)
    ref = jsample(JCfg(**kw), key, step)
    k_mode1, k_mode2, k_el, k_az, k_d, k_f = jax.random.split(key, 6)
    u = lambda k, s: t(jax.random.uniform(k, s))
    draws = CameraDraws(u(k_mode1, ()), u(k_mode2, ()), u(k_el, (3,)),
                        u(k_az, (3,)), u(k_d, (3,)), u(k_f, (3,)))
    got = train_batch_from_draws(CameraSamplerConfig(**kw), draws, step)
    for f in ref._fields:
        close(getattr(got, f), getattr(ref, f), atol=1e-5)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_orbit_batch(split):
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCfg
    from gaussianip_tpu.data.sampler import eval_orbit_batch as jorbit
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   eval_orbit_batch)

    kw = dict(n_val_views=4, n_test_views=6)
    ref = jorbit(JCfg(**kw), split)
    got = eval_orbit_batch(CameraSamplerConfig(**kw), split, device="cpu")
    for f in ref._fields:
        close(getattr(got, f), getattr(ref, f), atol=1e-5)


def test_knn_mean_dist2(rng):
    from gaussianip_tpu.ops.knn import knn_self_dist2 as jknn
    from gaussianip_tpu.ops.knn import mean_dist2_3nn as jmd
    from gaussianip_tpu_torch.ops.knn import knn_self_dist2, mean_dist2_3nn

    pts = rng.normal(0, 0.3, (300, 3)).astype(np.float32)
    # the |x|^2 + |y|^2 - 2 x.y expansion cancels: ~1e-7 absolute rounding
    close(mean_dist2_3nn(t(pts), block=128),
          jmd(jnp.asarray(pts), block=128), rtol=1e-5, atol=1e-6)
    _, idx = knn_self_dist2(t(pts), k=3, block=128)
    _, jidx = jknn(jnp.asarray(pts), k=3, block=128)
    assert (n(idx) == np.asarray(jidx)).mean() > 0.99
