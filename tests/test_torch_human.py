"""Parity of the port's SMPL-X body, skeleton and pose-map drawing with the
JAX package on the same numpy draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t

torch.set_num_threads(1)


def _skeletons(seed, n_verts=300, n_faces=200):
    from gaussianip_tpu.human.skeleton import Skeleton as JSkeleton
    from gaussianip_tpu.human.smplx_jax import make_test_model as jmake
    from gaussianip_tpu_torch.human.skeleton import Skeleton
    from gaussianip_tpu_torch.human.smplx import make_test_model

    jsk = JSkeleton(_test_model=jmake(np.random.default_rng(seed), n_verts,
                                      n_faces))
    sk = Skeleton(_test_model=make_test_model(np.random.default_rng(seed),
                                              n_verts, n_faces, device="cpu"))
    return jsk, sk


@pytest.mark.parametrize("seed", [0, 1])
def test_make_test_model_and_forward(seed):
    from gaussianip_tpu.human.smplx_jax import smplx_forward as jfwd
    from gaussianip_tpu_torch.human.smplx import smplx_forward

    jsk, sk = _skeletons(seed)
    for f in ("v_template", "shapedirs", "exprdirs", "posedirs",
              "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(n(getattr(sk.params, f)),
                                      np.asarray(getattr(jsk.params, f)))
    for f in ("parents", "faces", "extra_joint_vids"):
        np.testing.assert_array_equal(getattr(sk.params, f),
                                      np.asarray(getattr(jsk.params, f)))
    rng = np.random.default_rng(seed + 10)
    pose = rng.normal(0, 0.3, (21, 3)).astype(np.float32)
    betas = rng.normal(0, 1, (10,)).astype(np.float32)
    ref = jfwd(jsk.params, betas=jnp.asarray(betas),
               body_pose=jnp.asarray(pose))
    got = smplx_forward(sk.params, betas=t(betas), body_pose=t(pose))
    for f in ref._fields:
        # f32 chains of 4x4 products down the kintree
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_skeleton_points():
    """forward_smplx + scale(-10) + sample_smplx_points give the same
    keypoints and the same surface points."""
    jsk, sk = _skeletons(0)
    for s in (jsk, sk):
        s.forward_smplx()
        s.scale(-10)
    np.testing.assert_allclose(sk.points3d, jsk.points3d, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sk.hand_centers, jsk.hand_centers, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sk.sample_smplx_points(500, seed=3),
                               jsk.sample_smplx_points(500, seed=3),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_openpose_draw(seed):
    """Pose images of a sampled camera batch (the stage-1 step's inputs).
    Keypoints agree to 1e-4 px, so pixels are equal except where a circle
    or ellipse boundary passes within that distance of a pixel centre:
    at most 0.1% of the pixels may differ."""
    from gaussianip_tpu.data.sampler import CameraSamplerConfig
    from gaussianip_tpu.data.sampler import sample_train_batch
    from gaussianip_tpu.human.posemap import openpose_draw as jdraw
    from gaussianip_tpu_torch.human.posemap import openpose_draw

    jsk, _ = _skeletons(0)
    jsk.forward_smplx()
    jsk.scale(-10)
    h = w = 64
    cfg = CameraSamplerConfig(height=h, width=w, batch_size=4,
                              head_start_step=0, back_start_step=0,
                              head_prob=0.5)
    batch = sample_train_batch(cfg, jax.random.PRNGKey(seed), 0)
    head_zoom = (batch.center_z == 0.65) & (batch.azimuth_deg > 0)
    pts = jnp.asarray(jsk.points3d)
    ref = jax.vmap(lambda m, a, hz: jdraw(pts, m, a, hz, h, w))(
        batch.mvp_mtx, batch.azimuth_deg, head_zoom)
    got = openpose_draw(t(jsk.points3d, np.float32), t(batch.mvp_mtx),
                        t(batch.azimuth_deg), t(head_zoom), h, w)
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(n(got[2]), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-4)
    diff = np.abs(n(got[0]) - np.asarray(ref[0])).max(axis=-1)
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).mean()
