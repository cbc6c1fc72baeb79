"""The port's LBS-weight deformation (human/lbs_deform.py), the
animation-space refine step (system/anim_refine.py), the mesh subdivision
(human/subdivide.py) and the HumanSD pose map (human/posemap.py:
humansd_draw) against the JAX package on the same numpy inputs.

The refine steps take the camera batch, the pose index and the guidance
draws from the JAX step's own key split (system/anim_refine.py: k_cam,
k_pose, k_guid = split(key, 3)). Tolerances: the deformation to 1e-5 of
each output's largest |value|, padded rows included (their blended
transform is 0: they land at the origin with the rotation (0, 0, 0, 1));
the loss to 1e-4 relative; the first step's gradients, read from Adam's
first moment (m = 0.1 g), within 1e-3 of each field's largest |value|
(the gaussians are anisotropic and randomly rotated, so that the rotation
gradient is signal); parameters as tests/test_torch_stage1.py: the 99th
percentile of |diff| within 2e-2 of the field's learning rate, and every
entry within Adam's bound of 2 lr per step (an entry whose gradient is
rounding noise can step either way) plus two float32 spacings of its
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PARAM_FIELDS, assert_rel_close, jax_draws, n, t,
                           tiny_guidance_pair, train_state_numpy)

torch.set_num_threads(1)
NV, NF, NPTS, CAP = 120, 100, 60, 96


@pytest.fixture(scope="module")
def bodies():
    from gaussianip_tpu.human.smplx_jax import make_test_model as jmake
    from gaussianip_tpu_torch.human.smplx import make_test_model

    return (jmake(np.random.default_rng(5), NV, NF),
            make_test_model(np.random.default_rng(5), NV, NF, device="cpu"))


def _points(rng, a_verts):
    """Gaussian centres near the A-pose vertices, then padded rows at
    PAD_XYZ."""
    pts = np.full((CAP, 3), 1e8, np.float32)
    pts[:NPTS] = (a_verts[:NPTS]
                  + rng.normal(0, 0.02, (NPTS, 3))).astype(np.float32)
    return pts


def test_lbs_diffuse_transforms(bodies, rng):
    from gaussianip_tpu.human.lbs_deform import lbs_diffuse_transforms as jd
    from gaussianip_tpu.human.smplx_jax import smplx_forward as jfwd
    from gaussianip_tpu_torch.human.lbs_deform import lbs_diffuse_transforms

    jm, tm = bodies
    out = jfwd(jm, body_pose=jnp.asarray(rng.normal(0, 0.2, (21, 3)),
                                         jnp.float32))
    a_verts = np.asarray(jfwd(jm).vertices)
    vt = np.asarray(out.vertex_transforms)
    pts = _points(rng, a_verts)
    ref = np.asarray(jd(jm.lbs_weights, jnp.asarray(vt), jnp.asarray(pts),
                        jnp.asarray(a_verts)))
    got = lbs_diffuse_transforms(tm.lbs_weights, t(vt), t(pts), t(a_verts))
    assert_rel_close(got, ref, 1e-5, "T")
    assert not n(got)[NPTS:].any()  # padded rows: T = 0
    assert np.abs(ref[:NPTS, 3, 3] - 1).max() < 1e-5  # weights sum to 1


def test_lbs_deformer(bodies, rng):
    from gaussianip_tpu.human.lbs_deform import LBSDeformer as JDef
    from gaussianip_tpu.model.gaussians import create_from_pcd as jcreate
    from gaussianip_tpu_torch.human.lbs_deform import LBSDeformer
    from gaussianip_tpu_torch.human.skeleton import apose_body_pose
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy

    from _torch_parity import jax_state_numpy

    jm, tm = bodies
    ap = apose_body_pose()
    jdef = JDef(jm, canonical_body_pose=jnp.asarray(ap))
    tdef = LBSDeformer(tm, canonical_body_pose=t(ap))
    for f in ("a_verts", "T_t2a", "inv_T_t2a", "canonical_offsets"):
        assert_rel_close(getattr(tdef, f), np.asarray(getattr(jdef, f)),
                         1e-5, f)
    pts = _points(rng, np.asarray(jdef.a_verts))
    js = jcreate(pts[:NPTS], np.full((NPTS, 3), 0.5, np.float32), CAP,
                 rng.uniform(1e-4, 1e-3, NPTS))
    rot = rng.normal(size=(NPTS, 4)).astype(np.float32)
    js = js.replace(rotation=js.rotation.at[:NPTS].set(jnp.asarray(rot)))
    ts = state_from_numpy(jax_state_numpy(js), "cpu")
    pose = rng.normal(0, 0.2, (21, 3)).astype(np.float32)
    orient = rng.normal(0, 0.2, 3).astype(np.float32)
    kw = dict(global_orient=orient, betas=rng.normal(0, 1, 10).astype(
        np.float32))
    ref_T = np.asarray(jdef.point_transforms(
        jnp.asarray(pose), js.xyz, **{k: jnp.asarray(v)
                                      for k, v in kw.items()}))
    got_T = tdef.point_transforms(t(pose), ts.xyz,
                                  **{k: t(v) for k, v in kw.items()})
    assert_rel_close(got_T, ref_T, 1e-5, "point_transforms")
    jxyz, jrot = (np.asarray(x) for x in jdef.deform_gaussians(
        js, jnp.asarray(pose)))
    xyz, rot2 = tdef.deform_gaussians(ts, t(pose))
    assert_rel_close(xyz, jxyz, 1e-5, "xyz")
    assert_rel_close(rot2, jrot, 1e-5, "rotation")
    # padded rows: at the origin, rotation (0, 0, 0, 1) x (1, 0, 0, 0)
    assert not n(xyz)[NPTS:].any()
    np.testing.assert_array_equal(n(rot2)[NPTS:], np.tile([0, 0, 0, 1.0],
                                                          (CAP - NPTS, 1)))


def _refine_setup(bodies, h, batch):
    """(JAX train state, canonical dicts, motion, camera configs)."""
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCam
    from gaussianip_tpu.human.smplx_jax import smplx_forward as jfwd
    from gaussianip_tpu.model.gaussians import create_from_pcd as jcreate
    from gaussianip_tpu.system.stage1 import init_train_state
    from gaussianip_tpu_torch.data.sampler import CameraSamplerConfig
    from gaussianip_tpu_torch.human.lbs_deform import LBSDeformer

    jm, tm = bodies
    rng = np.random.default_rng(11)
    out_a = jfwd(jm)
    jcan = {"a_verts": out_a.vertices,
            "inv_T_t2a": jnp.linalg.inv(out_a.vertex_transforms),
            "canonical_offsets": out_a.shape_offsets + out_a.pose_offsets}
    d = LBSDeformer(tm)
    tcan = {"a_verts": d.a_verts, "inv_T_t2a": d.inv_T_t2a,
            "canonical_offsets": d.canonical_offsets}
    pts = _points(rng, np.asarray(out_a.vertices))[:NPTS]
    cols = rng.uniform(0, 1, (NPTS, 3)).astype(np.float32)
    js = jcreate(pts, cols, CAP, rng.uniform(1e-4, 1e-3, NPTS))
    # anisotropic scales and random rotations: the rotation gradient is
    # signal, not rounding noise
    js = js.replace(
        opacity=js.opacity.at[:NPTS].set(jnp.asarray(
            rng.uniform(-1, 2, (NPTS, 1)).astype(np.float32))),
        scaling=js.scaling.at[:NPTS].add(jnp.asarray(
            rng.uniform(-0.7, 0.7, (NPTS, 3)).astype(np.float32))),
        rotation=js.rotation.at[:NPTS].set(jnp.asarray(
            rng.normal(size=(NPTS, 4)).astype(np.float32))))
    motion = rng.normal(0, 0.1, (5, 21, 3)).astype(np.float32)
    cam = dict(height=h, width=h, batch_size=batch, head_start_step=0,
               back_start_step=0)
    return (init_train_state(js), jcan, tcan, motion, JCam(**cam),
            CameraSamplerConfig(**cam))


def _render_cfgs():
    from gaussianip_tpu.render.render import RenderConfig as JRender
    from gaussianip_tpu_torch.render.render import RenderConfig

    return (JRender(backend="pallas", interpret=True, d_max=16,
                    depth_key="exact2", sort_stable=True, tri="highest",
                    table_gather="i32"),
            RenderConfig(d_max=16, depth_key="exact2", sort_stable=True))


def _compare(ts, jts, i, lrs):
    assert ts.step == int(jts.step)
    for f in PARAM_FIELDS:
        a = n(getattr(ts.gaussians, f))
        b = np.asarray(getattr(jts.gaussians, f))
        if a.size == 0:
            continue
        d = np.abs(a - b)
        lr = float(lrs[f])
        assert np.quantile(d / lr, 0.99) <= 2e-2, f
        ulp = np.spacing(np.abs(b).astype(np.float32))  # the value's rounding
        assert (d <= 2 * lr * (i + 1) + 2 * ulp).all(), f
        if i == 0:  # m = 0.1 g after the first step
            assert_rel_close(ts.opt.m[f], np.asarray(jts.opt.m[f]), 1e-3,
                             f"grad {f}")


def _run_steps(bodies, h, batch, jguid, guid, n_steps, draws_of, seed0):
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.anim_refine import AnimRefineConfig as JCfg
    from gaussianip_tpu.system.anim_refine import make_anim_refine_step
    from gaussianip_tpu_torch.data.sampler import CameraBatch
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.system.anim_refine import (
        AnimRefineConfig, make_anim_refine_inner)
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    jm, tm = bodies
    jts, jcan, tcan, motion, jcam, cam = _refine_setup(bodies, h, batch)
    jrcfg, rcfg = _render_cfgs()
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    jstep = make_anim_refine_step(JCfg(render_height=h, render_width=h),
                                  jcam, jrcfg, JAdam(), jguid, jm, motion,
                                  jcan)
    inner = make_anim_refine_inner(
        AnimRefineConfig(render_height=h, render_width=h), cam, rcfg,
        AdamHyper(), guid, tm, motion, tcan)
    lrs = field_lrs(JAdam(), 0)
    poses = set()
    for i in range(n_steps):
        key = jax.random.PRNGKey(seed0 + i)
        k_cam, k_pose, k_guid = jax.random.split(key, 3)
        jb = jsample(jcam, k_cam, jts.step)
        pose = int(jax.random.randint(k_pose, (), 0, motion.shape[0]))
        poses.add(pose)
        jts, jmet = jstep(jts, key)
        ts, met = inner(ts, CameraBatch(*(t(x) for x in jb)), pose,
                        draws_of(k_guid))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        _compare(ts, jts, i, lrs)
    assert float(np.abs(n(ts.opt.m["xyz"])[:NPTS]).max()) > 0
    assert not n(ts.opt.m["xyz"])[NPTS:].any()  # padded rows: no gradient
    return poses


def test_anim_refine_stub_steps(bodies):
    from gaussianip_tpu.guidance.stub import make_stub_guidance as jstub
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance

    h, b = 32, 2
    tgt = np.zeros((h, h, 3), np.float32)
    tgt[8:24, 8:24] = 0.8
    poses = _run_steps(
        bodies, h, b, jstub(jnp.asarray(tgt), 0.01),
        make_stub_guidance(tgt, 0.01), 3,
        lambda k: t(jax.random.normal(k, (b, h, h, 3))), 20)
    assert len(poses) > 1


def test_anim_refine_ahds_step(bodies):
    """One step with the tiny AHDS stack (tests/_torch_parity.py:
    tiny_guidance_pair) at 64^2."""
    h, b = 64, 2
    jg, g = tiny_guidance_pair(np.random.default_rng(31), image_size=h)
    _run_steps(bodies, h, b, jg, g, 1, lambda k: jax_draws(k, b, h // 2), 40)


def test_anim_refine_step_draws(bodies):
    """make_anim_refine_step draws camera batch, pose index and noise from
    its generator: the same seed gives the same step, another seed
    another."""
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.system.anim_refine import (
        AnimRefineConfig, make_anim_refine_step)
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    _, tm = bodies
    jts, _, tcan, motion, _, cam = _refine_setup(bodies, 32, 1)
    step = make_anim_refine_step(
        AnimRefineConfig(render_height=32, render_width=32), cam,
        _render_cfgs()[1], AdamHyper(), make_stub_guidance(None, 0.01), tm,
        motion, tcan)
    losses = []
    for seed in (0, 0, 1):
        ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
        ts, m = step(ts, torch.Generator().manual_seed(seed))
        assert ts.step == 1 and np.isfinite(float(m["loss"]))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("with_attrs", [False, True])
def test_subdivide(rng, with_attrs):
    from gaussianip_tpu.human.subdivide import subdivide_n as jsub
    from gaussianip_tpu_torch.human.subdivide import subdivide_n

    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (50, 3))
    attrs = rng.uniform(size=(40, 55)).astype(np.float32) if with_attrs \
        else None
    ref = jsub(verts, faces, 2, attrs)
    got = subdivide_n(verts, faces, 2, attrs)
    assert len(got) == len(ref) == (3 if with_attrs else 2)
    assert got[1].shape == (50 * 16, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _mvp(eye):
    from gaussianip_tpu.ops.camera_math import (get_mvp_matrix,
                                                gl_projection_matrix,
                                                look_at_c2w)

    c2w = look_at_c2w(jnp.asarray([eye], jnp.float32), jnp.zeros((1, 3)),
                      jnp.array([[0.0, 0, 1]]))
    proj = gl_projection_matrix(jnp.array([1.0]), 1.0, 0.1, 1000.0)
    return np.asarray(get_mvp_matrix(c2w, proj)[0])


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("view", ["front", "back", "left", "right"])
def test_humansd_draw(rng, occlusion, view):
    """Canvas and keypoints, with and without the occlusion rules, in the
    four views that decide them (the camera looks down -x)."""
    from gaussianip_tpu.human.posemap import humansd_draw as jdraw
    from gaussianip_tpu_torch.human.posemap import humansd_draw

    pts = rng.uniform(-0.3, 0.3, (18, 3)).astype(np.float32)
    # nose (op18 0) against the ears (16 right, 17 left) along the view
    depth = {"front": (0.3, -0.2, -0.2), "back": (-0.5, 0.4, 0.4),
             "left": (0.0, -0.3, 0.3), "right": (0.0, 0.3, -0.3)}[view]
    pts[[0, 16, 17], 0] = depth
    mvp = _mvp([2.0, 0.0, 0.0])
    ref = jdraw(jnp.asarray(pts), jnp.asarray(mvp), 96, 96,
                enable_occlusion=occlusion)
    got = humansd_draw(t(pts), t(mvp), 96, 96, enable_occlusion=occlusion)
    np.testing.assert_allclose(n(got[1]), np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-4)
    diff = np.abs(n(got[0]) - np.asarray(ref[0])).max(axis=-1)
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).mean()
    assert float(n(got[0]).max()) > 0.3
    if occlusion and view != "front":
        assert (n(got[1])[0, :, 2] == 0).any()
