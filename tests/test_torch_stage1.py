"""The port's stage-1 step, densify and prune against the JAX package on the
same state, camera batches and stub-guidance noise.

The camera batch and the noise come from the JAX step's own key split
(k_cam, k_guid = split(key), as system/stage1.py:131-132) and go into the
port's inner step. The stub's target image has the render's size, so no
resize runs (jax.image.resize antialiases on downscale; the port's bilinear
resize is compared on its own below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PARAM_FIELDS, n, stage1_scene, t,
                           train_state_numpy)

torch.set_num_threads(1)
H = W = 32
B = 2
MOM_TOL = {"m": 1e-2, "v": 2e-2}


@pytest.fixture(scope="module")
def scene():
    return stage1_scene()


def _configs():
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCam
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.render.render import RenderConfig as JRender
    from gaussianip_tpu.system.stage1 import Stage1Config as JS1
    from gaussianip_tpu_torch.data.sampler import CameraSamplerConfig
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.stage1 import Stage1Config

    s1 = dict(render_height=H, render_width=W)
    cam = dict(height=H, width=W, batch_size=B, head_start_step=0,
               back_start_step=0)
    return ((JS1(**s1), JCam(**cam), JAdam(),
             JRender(backend="pallas", interpret=True, d_max=16,
                     depth_key="exact2", sort_stable=True, tri="highest",
                     table_gather="i32")),
            (Stage1Config(**s1), CameraSamplerConfig(**cam), AdamHyper(),
             RenderConfig(d_max=16, depth_key="exact2", sort_stable=True)))


def test_three_steps_match(scene):
    """Loss, parameters, Adam moments and densify stats after each of 3
    steps. The step's gradients agree with JAX within the render tests'
    bounds (rtol 2e-2; single pixels flip across the alpha and T gates), so:
    the loss to 1e-4 relative; Adam m and the densify stats to 1e-2 of the
    field's largest |value|, v (a square) to 2e-2; parameters: the 99th
    percentile of |diff| within 2e-2 of the field's learning rate, and
    every entry within Adam's bound of 2 lr per step (an entry whose
    gradient is rounding noise can take a normalized step of either sign). The rotation gradient of these isotropic gaussians is rounding
    noise throughout, so rotation is held to the 2 lr per step bound only,
    and its moments, whose size is that noise, are not compared."""
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu.guidance.stub import make_stub_guidance as jstub
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage1 import make_train_step as jmake
    from gaussianip_tpu_torch.data.sampler import CameraBatch
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.system.stage1 import (make_inner_step,
                                                    train_state_from_numpy)

    sk, jts = scene
    jts = jax.tree_util.tree_map(jnp.array, jts)  # the JAX step donates it
    (js1, jcam, jadam, jrcfg), (s1, cam, adam, rcfg) = _configs()
    tgt = np.zeros((H, W, 3), np.float32)
    tgt[8:24, 8:24] = 0.8
    jstep = jmake(js1, jcam, jrcfg, jadam, jstub(jnp.asarray(tgt), 0.01),
                  sk.points3d)
    inner = make_inner_step(s1, cam, rcfg, adam, make_stub_guidance(tgt, 0.01),
                            sk.points3d)
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    lrs = field_lrs(jadam, 0)
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        k_cam, k_guid = jax.random.split(key)
        jb = jsample(jcam, k_cam, jts.step)
        noise = jax.random.normal(k_guid, (B, H, W, 3))
        jts, jm = jstep(jts, key)
        ts, m = inner(ts, CameraBatch(*(t(x) for x in jb)), t(noise))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert ts.step == int(jts.step) and ts.gaussians.n_active == 400
        for f in PARAM_FIELDS:
            a = n(getattr(ts.gaussians, f))
            b = np.asarray(getattr(jts.gaussians, f))
            if a.size == 0:
                continue
            d = np.abs(a - b)
            lr = float(lrs[f])
            if f != "rotation":
                assert np.quantile(d / lr, 0.99) <= 2e-2, f
            assert d.max() <= 2 * lr * (i + 1) + 1e-7, f
            for mom in ("m", "v") if f != "rotation" else ():
                a = n(getattr(ts.opt, mom)[f])
                b = np.asarray(getattr(jts.opt, mom)[f])
                tol = MOM_TOL[mom] * max(np.abs(b).max(), 1e-30)
                assert np.abs(a - b).max() <= tol, (f, mom)
        for f in ("xyz_grad_accum", "denom", "max_radii2d"):
            a, b = n(getattr(ts.stats, f)), np.asarray(getattr(jts.stats, f))
            assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1e-30), f


def _compare_states(got, ref, atol=1e-6):
    assert got.gaussians.n_active == int(ref.gaussians.n_active)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(n(getattr(got.gaussians, f)),
                                   np.asarray(getattr(ref.gaussians, f)),
                                   rtol=1e-6, atol=atol, err_msg=f)
        for mom in ("m", "v"):
            np.testing.assert_array_equal(n(getattr(got.opt, mom)[f]),
                                          np.asarray(getattr(ref.opt, mom)[f]))
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(n(getattr(got.stats, f)),
                                      np.asarray(getattr(ref.stats, f)))


def _hot_state(jts, rng):
    """The scene with random accumulated stats, scales and opacities so that
    clone, split and both prunes all fire."""
    cap = jts.gaussians.capacity
    g = jts.gaussians
    scaling = np.asarray(g.scaling).copy()
    scaling[:400] += rng.uniform(-1.0, 1.5, (400, 1)).astype(np.float32)
    opacity = np.asarray(g.opacity).copy()
    opacity[:400] = rng.uniform(-5, 3, (400, 1)).astype(np.float32)
    m = {f: jnp.asarray(rng.normal(0, 1, a.shape).astype(np.float32))
         for f, a in jts.opt.m.items()}
    stats = jts.stats.replace(
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 1e-3, cap)
                                   .astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 3, cap).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 9, cap).astype(np.float32)))
    return jts._replace(
        gaussians=g.replace(scaling=jnp.asarray(scaling),
                            opacity=jnp.asarray(opacity)),
        opt=jts.opt.replace(m=m, v=m), stats=stats)


def test_densify_and_prune_match(scene, rng):
    from gaussianip_tpu.system.stage1 import make_densify_fns as jfns
    from gaussianip_tpu_torch.system.stage1 import (TrainState,
                                                    make_densify_fns,
                                                    train_state_from_numpy)

    _, jts = scene
    jts = _hot_state(jts, rng)
    (js1, *_), (s1, *_) = _configs()
    jdens, jprune = jfns(js1)
    densify, prune = make_densify_fns(s1)
    key = jax.random.PRNGKey(5)
    ref, jdropped = jdens(jts, key)
    noise = jax.random.normal(key, (2, jts.gaussians.capacity, 3))

    from gaussianip_tpu_torch.model.densify import densify_and_prune
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    g, opt, stats, dropped = densify_and_prune(
        ts.gaussians, ts.opt, ts.stats, t(noise), max_grad=s1.max_grad,
        min_opacity=s1.densify_prune_min_opacity, extent=s1.cameras_extent,
        max_world_size=s1.densify_prune_world_size_threshold)
    got = TrainState(g, opt, stats, ts.step)
    n_new = got.gaussians.n_active
    assert 0 < n_new != 400 and dropped == int(jdropped)
    # child positions go through a rotation einsum: f32 rounding
    _compare_states(got, ref, atol=1e-6)

    ts2 = train_state_from_numpy(train_state_numpy(jts), "cpu")
    got_p = prune(ts2)
    ref_p = jprune(jts)
    assert got_p.gaussians.n_active < 400
    _compare_states(got_p, ref_p)


def test_stub_resize_matches_jax():
    """The stub's bilinear target resize against jax.image.resize
    ("linear", antialiased when shrinking), up and down."""
    from gaussianip_tpu_torch.guidance.stub import StubGuidance

    img = np.random.default_rng(0).uniform(0, 1, (24, 24, 3)).astype(
        np.float32)
    for size in ((48, 48), (16, 16), (12, 36)):
        ref = jax.image.resize(jnp.asarray(img), size + (3,), "linear")
        got = StubGuidance(img)._target(*size, "cpu")[0]
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


def test_train_stage1_runs(scene):
    """The host loop on the CPU: steps, a densify boundary, finite loss."""
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.system.stage1 import (Stage1Config,
                                                    train_stage1,
                                                    train_state_from_numpy)

    sk, jts = scene
    (_, _, _, _), (_, cam, adam, rcfg) = _configs()
    s1 = Stage1Config(render_height=H, render_width=W,
                      densify_prune_start_step=0, densify_prune_interval=2,
                      densify_prune_world_size_threshold=2.0)
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    gen = torch.Generator().manual_seed(0)
    logs = []
    ts = train_stage1(ts, s1, cam, rcfg, adam,
                      make_stub_guidance(np.zeros((16, 16, 3), np.float32),
                                         0.01),
                      sk.points3d, gen, n_steps=3, log_every=1,
                      log_fn=lambda i, m: logs.append(m))
    assert ts.step == 3 and len(logs) == 3
    assert all(np.isfinite(m["loss"]) for m in logs)
    assert ts.gaussians.n_active > 400  # the step-2 densify cloned/split
