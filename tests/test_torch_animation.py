"""The port's animation path against the JAX package on the same numpy
inputs: the closest-point binding (ops/triangle.py), the cross-set k-NN
(ops/knn.py:knn_dist2), the rotation conversions (ops/rotations.py),
pad_to_capacity, the animation .ply shim, AvatarAnimator (bind, repose,
render_frame, render_motion) and the entry point
`python -m gaussianip_tpu_torch.animation`.

Ties: a point whose closest point lies on an edge shared by two faces is
as close to both, and the two packages may round the two distances in a
different order; so faces, barycentrics and signs are compared where the
best face's d^2 beats the second best by more than 1e-6, and |d| and the
closest point everywhere. Renders use the render tests' tolerances
(tests/test_torch_render.py): q99 |diff| < 3e-4 with a worst case < 100x.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close, jax_state_numpy, n, t

torch.set_num_threads(1)
TIE = 1e-6


def _tri():
    a = np.array([0.0, 0, 0], np.float32)
    b = np.array([1.0, 0, 0], np.float32)
    c = np.array([0.0, 1, 0], np.float32)
    return a, b, c


# one point in each Voronoi region of the triangle (0,0,0) (1,0,0) (0,1,0)
REGIONS = {
    "face": ([0.25, 0.25, 1.0], [0.5, 0.25, 0.25]),
    "a": ([-1.0, -1.0, 0.3], [1, 0, 0]),
    "b": ([2.0, -0.5, -0.2], [0, 1, 0]),
    "c": ([-0.5, 2.0, 0.1], [0, 0, 1]),
    "ab": ([0.5, -1.0, 0.0], [0.5, 0.5, 0]),
    "ac": ([-1.0, 0.25, 0.5], [0.75, 0, 0.25]),
    "bc": ([1.0, 1.0, -0.4], [0, 0.5, 0.5]),
}


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_closest_point_regions(region):
    from gaussianip_tpu.ops.triangle import closest_point_barycentric as jcp
    from gaussianip_tpu_torch.ops.triangle import closest_point_barycentric

    p, want = REGIONS[region]
    a, b, c = _tri()
    p = np.asarray(p, np.float32)
    ref = np.asarray(jcp(jnp.asarray(p), *map(jnp.asarray, (a, b, c))))
    got = n(closest_point_barycentric(t(p), t(a), t(b), t(c)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_closest_point_random(rng):
    """Random points against random (also degenerate-free) triangles,
    broadcast [P, F, 3]."""
    from gaussianip_tpu.ops.triangle import closest_point_barycentric as jcp
    from gaussianip_tpu_torch.ops.triangle import closest_point_barycentric

    p = rng.normal(size=(64, 1, 3)).astype(np.float32)
    tri = rng.normal(size=(3, 1, 40, 3)).astype(np.float32)
    ref = np.asarray(jcp(jnp.asarray(p), *map(jnp.asarray, tri)))
    got = n(closest_point_barycentric(t(p), *map(t, tri)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (np.count_nonzero(ref, axis=-1) < 3).any()  # edges, vertices


def _dense_margin(pts, verts, faces):
    """The gap between each point's best and second-best face d^2, from a
    dense float64 evaluation."""
    from gaussianip_tpu.ops.triangle import closest_point_barycentric as jcp

    a, b, c = (verts[faces[:, i]] for i in range(3))
    uvw = np.asarray(jcp(jnp.asarray(pts)[:, None], jnp.asarray(a)[None],
                         jnp.asarray(b)[None], jnp.asarray(c)[None]),
                     np.float64)
    cp = uvw[..., :1] * a + uvw[..., 1:2] * b + uvw[..., 2:3] * c
    d2 = np.sort(((pts[:, None] - cp) ** 2).sum(-1), axis=1)
    return d2[:, 1] - d2[:, 0]


def _closest(verts, faces, fi, uvw):
    fa = faces[fi]
    return (uvw[:, :1] * verts[fa[:, 0]] + uvw[:, 1:2] * verts[fa[:, 1]]
            + uvw[:, 2:3] * verts[fa[:, 2]])


def test_signed_distance_blocked(rng):
    """Point blocks smaller than P and a face count that is no multiple of
    the face block."""
    from gaussianip_tpu.ops.triangle import signed_distance_to_mesh as jsd
    from gaussianip_tpu_torch.ops.triangle import signed_distance_to_mesh

    verts = rng.normal(size=(60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (90, 3))
    pts = (rng.normal(size=(300, 3)) * 1.5).astype(np.float32)
    jd, jf, ju = (np.asarray(x) for x in jsd(
        jnp.asarray(pts), jnp.asarray(verts),
        jnp.asarray(faces.astype(np.int32)), face_block=32))
    d, f, u = (n(x) for x in signed_distance_to_mesh(
        t(pts), t(verts), t(faces), face_block=32, point_block=70))
    np.testing.assert_allclose(np.abs(d), np.abs(jd), atol=1e-5)
    np.testing.assert_allclose(_closest(verts, faces, f, u),
                               _closest(verts, faces, jf, ju), atol=1e-5)
    clear = _dense_margin(pts, verts, faces) > TIE
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(f[clear], jf[clear])
    np.testing.assert_allclose(u[clear], ju[clear], atol=1e-5)
    np.testing.assert_array_equal(np.sign(d[clear]), np.sign(jd[clear]))


def test_knn_dist2(rng):
    """Indices off ties, distances to 1e-5 of the largest, and the gradient
    of a weighted sum of exp(-d2) with respect to queries and points."""
    from gaussianip_tpu.ops.knn import knn_dist2 as jknn
    from gaussianip_tpu_torch.ops.knn import knn_dist2

    q = rng.normal(size=(300, 3)).astype(np.float32)
    p = rng.normal(size=(200, 3)).astype(np.float32)
    wts = rng.uniform(size=(300, 6)).astype(np.float32)
    jd, ji = (np.asarray(x) for x in jknn(jnp.asarray(q), jnp.asarray(p),
                                          k=6, block=64))
    tq, tp = t(q).requires_grad_(True), t(p).requires_grad_(True)
    d, i = knn_dist2(tq, tp, k=6, block=64)
    assert_rel_close(d, jd, 1e-5, "d2")
    full = np.sort(((q[:, None] - p[None]) ** 2).sum(-1), axis=1)[:, :7]
    clear = (np.diff(full, axis=1) > 1e-5).all(axis=1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(n(i)[clear], ji[clear])

    def jloss(qq, pp):
        return jnp.sum(wts * jnp.exp(-jknn(qq, pp, k=6, block=64)[0]))

    jgq, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    gq, gp = torch.autograd.grad((t(wts) * torch.exp(-d)).sum(), [tq, tp])
    assert_rel_close(gq, np.asarray(jgq), 1e-5, "dq")
    assert_rel_close(gp, np.asarray(jgp), 1e-5, "dp")


def _rot_inputs(rng):
    from gaussianip_tpu.ops.rotations import axis_angle_to_matrix

    aa = rng.normal(0, 1.2, (64, 3)).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [np.pi - 1e-3, 0, 0]  # trace < 0: the x branch
    aa[2] = [0, np.pi - 1e-3, 0]  # the y branch
    aa[3] = [0, 0, np.pi - 1e-3]  # the z branch
    R = np.asarray(axis_angle_to_matrix(jnp.asarray(aa)))
    R = np.concatenate([R, np.zeros((1, 3, 3), np.float32)])  # T = 0 rows
    return aa, R


ROT_FNS = ("rotmat_to_quat", "matrix_to_axis_angle", "matrix_to_rotation_6d",
           "axis_angle_to_quat", "axis_angle_to_matrix", "quat_to_axis_angle",
           "quat_invert", "quat_to_rotmat", "quat_multiply",
           "euler_to_matrix", "rotation_6d_to_matrix")


@pytest.mark.parametrize("name", ROT_FNS)
def test_rotations(rng, name):
    from gaussianip_tpu.ops import rotations as jr
    from gaussianip_tpu_torch.ops import rotations as tr

    aa, R = _rot_inputs(rng)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    d6 = rng.normal(size=(64, 6)).astype(np.float32)
    args = {"rotmat_to_quat": (R,), "matrix_to_axis_angle": (R[:-1],),
            "matrix_to_rotation_6d": (R,), "axis_angle_to_quat": (aa,),
            "axis_angle_to_matrix": (aa,), "quat_to_axis_angle": (q,),
            "quat_invert": (q,), "quat_to_rotmat": (q,),
            "quat_multiply": (q, q2), "euler_to_matrix": (aa,),
            "rotation_6d_to_matrix": (d6,)}[name]
    ref = np.asarray(getattr(jr, name)(*map(jnp.asarray, args)))
    got = n(getattr(tr, name)(*map(t, args)))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)
    if name == "euler_to_matrix":
        for conv in ("ZYX", "YXZ"):
            np.testing.assert_allclose(
                n(tr.euler_to_matrix(t(aa), conv)),
                np.asarray(jr.euler_to_matrix(jnp.asarray(aa), conv)),
                atol=2e-6)


def test_rotmat_to_quat_gradient(rng):
    """Through every Shepperd branch and the all-zero matrix of a padded
    row: finite and equal to jax.grad."""
    from gaussianip_tpu.ops.rotations import rotmat_to_quat as jq
    from gaussianip_tpu_torch.ops.rotations import rotmat_to_quat

    _, R = _rot_inputs(rng)
    wq = rng.normal(size=(R.shape[0], 4)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda r: jnp.sum(wq * jq(r)))(jnp.asarray(R)))
    tR = t(R).requires_grad_(True)
    (g,) = torch.autograd.grad((t(wq) * rotmat_to_quat(tR)).sum(), [tR])
    assert np.isfinite(n(g)).all()
    assert_rel_close(g, jg, 1e-5, "dR")
    np.testing.assert_allclose(n(rotmat_to_quat(t(R[-1:]))), [[0, 0, 0, 1]])


def test_pad_to_capacity(rng):
    from gaussianip_tpu.model.gaussians import empty_state as jempty
    from gaussianip_tpu.model.gaussians import pad_to_capacity as jpad
    from gaussianip_tpu_torch.model.gaussians import (PARAM_FIELDS,
                                                      empty_state,
                                                      pad_to_capacity)

    arrays = {"xyz": rng.normal(size=(5, 3)), "f_dc": rng.normal(
        size=(5, 1, 3)), "f_rest": rng.normal(size=(5, 3, 3)),
        "opacity": rng.normal(size=(5, 1))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    ref = jpad(jempty(16, 1), {k: jnp.asarray(v) for k, v in arrays.items()},
               5)
    got = pad_to_capacity(empty_state(16, 1, "cpu"), arrays, 5)
    assert got.n_active == int(ref.n_active) == 5
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    with pytest.raises(ValueError):
        pad_to_capacity(empty_state(4, 1, "cpu"), arrays, 5)


def _write_ply(path, rng, n_pts, deg):
    from gaussianip_tpu_torch.model.ply import save_ply

    r = (deg + 1) ** 2 - 1
    save_ply(path, rng.normal(0, 0.5, (n_pts, 3)),
             rng.normal(size=(n_pts, 1, 3)), rng.normal(size=(n_pts, r, 3)),
             rng.normal(size=(n_pts, 1)), rng.normal(-3, 0.3, (n_pts, 3)),
             rng.normal(size=(n_pts, 4)))


@pytest.mark.parametrize("deg", [0, 3])
def test_load_animation_ply(tmp_path, rng, deg):
    from gaussianip_tpu.human.animation import load_animation_ply as jload
    from gaussianip_tpu_torch.human.animation import load_animation_ply

    p = str(tmp_path / "a.ply")
    _write_ply(p, rng, 4100, deg)  # capacity rounds up to 8192
    ref = jload(p)
    got = load_animation_ply(p, device="cpu")
    d = jax_state_numpy(ref)
    assert got.capacity == ref.capacity == 8192
    assert (got.n_active, got.max_sh_degree, got.active_sh_degree) == (
        d["n_active"], d["max_sh_degree"], d["active_sh_degree"])
    for f in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(n(getattr(got, f)), d[f], err_msg=f)


# ---------------------------------------------------------------------------
# AvatarAnimator

NV, NF, NPTS, CAP = 150, 200, 400, 512


def _motion(rng, flat=False):
    m = rng.normal(0, 0.05, (6, 55, 3)).astype(np.float32)
    return m.reshape(6, 165) if flat else m


@pytest.fixture(scope="module")
def animators():
    """(JAX animator, port animator) on one synthetic body and motion,
    holding the same gaussians: 70% on the frame-0 mesh's faces, the rest
    pushed off it (some of which the bind culls)."""
    from gaussianip_tpu.human.animation import AvatarAnimator as JAnim
    from gaussianip_tpu.human.smplx_jax import make_test_model as jmake
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.human.animation import AvatarAnimator
    from gaussianip_tpu_torch.human.smplx import make_test_model
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy

    rng = np.random.default_rng(7)
    jm = jmake(np.random.default_rng(3), NV, NF)
    tm = make_test_model(np.random.default_rng(3), NV, NF, device="cpu")
    motion = _motion(rng)
    ja = JAnim(None, jm, motion_poses=motion)
    verts0 = np.asarray(ja._mesh_at(0))
    faces = np.asarray(jm.faces)
    fidx = rng.integers(0, NF, NPTS)
    bary = rng.dirichlet((1, 1, 1), NPTS).astype(np.float32)
    pts = np.einsum("pk,pkc->pc", bary, verts0[faces[fidx]])
    off = rng.uniform(size=NPTS) < 0.3
    pts[off] += rng.normal(0, 0.05, (off.sum(), 3))
    pts = pts.astype(np.float32)
    cols = rng.uniform(0, 1, (NPTS, 3)).astype(np.float32)
    js = create_from_pcd(pts, cols, CAP, rng.uniform(1e-4, 1e-3, NPTS))
    js = js.replace(opacity=jnp.asarray(
        rng.uniform(-1, 3, (CAP, 1)).astype(np.float32)))
    ja.gaussians = js
    ta = AvatarAnimator(state_from_numpy(jax_state_numpy(js), "cpu"), tm,
                        motion_poses=motion)
    return ja, ta, pts


def test_motion_layouts(rng):
    from gaussianip_tpu.human.animation import AvatarAnimator as JAnim
    from gaussianip_tpu.human.smplx_jax import make_test_model as jmake
    from gaussianip_tpu_torch.human.animation import AvatarAnimator
    from gaussianip_tpu_torch.human.smplx import make_test_model
    from gaussianip_tpu_torch.model.gaussians import empty_state

    m3 = _motion(rng)
    tm = make_test_model(np.random.default_rng(0), 60, 80, device="cpu")
    st = empty_state(64, 0, "cpu")
    a1 = AvatarAnimator(st, tm, motion_poses=m3)
    a2 = AvatarAnimator(st, tm, motion_poses=m3.reshape(6, 165))
    ja = JAnim(None, jmake(np.random.default_rng(0), 60, 80), motion_poses=m3)
    assert a1.motion.shape == (6, 21, 3) and a1.n_frames == 6
    np.testing.assert_array_equal(a1.motion, a2.motion)
    np.testing.assert_array_equal(a1.motion, ja.motion)
    with pytest.raises(ValueError):
        AvatarAnimator(st, tm, motion_poses=m3.reshape(6, 165)[:, :164])


def test_mesh_at(animators):
    ja, ta, _ = animators
    for frame in (0, 4):
        np.testing.assert_allclose(n(ta._mesh_at(frame)),
                                   np.asarray(ja._mesh_at(frame)),
                                   atol=1e-5)
    # the recentre / rescale constants are the first frame's
    np.testing.assert_allclose(ta.ori_center, ja.ori_center, atol=1e-6)
    np.testing.assert_allclose(ta.ori_scale, ja.ori_scale, rtol=1e-6)


def _bound(animators):
    """Both animators bound on the same (JAX) frame-0 mesh; the mesh
    itself is held by test_mesh_at."""
    import copy

    ja, ta, pts = animators
    ja, ta = copy.copy(ja), copy.copy(ta)
    verts0 = ja._mesh_at(0)
    ta._mesh_at = lambda frame: t(np.asarray(ja._mesh_at(frame)))
    jc = ja.bind(0, face_block=64)
    tc = ta.bind(0, face_block=64)
    return ja, ta, jc, tc, pts, np.asarray(verts0)


def test_bind(animators):
    ja, ta, jc, tc, pts, verts0 = _bound(animators)
    assert 0 < tc == jc < NPTS // 2
    faces = np.asarray(ja.params.faces)
    clear = _dense_margin(pts, verts0, faces) > TIE
    assert clear.mean() > 0.8
    n_kept = NPTS - jc
    assert ta.gaussians.n_active == int(ja.gaussians.n_active) == n_kept
    assert ta.gaussians.capacity == CAP
    jg = jax_state_numpy(ja.gaussians)
    for f in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(n(getattr(ta.gaussians, f)), jg[f],
                                      err_msg=f)
    # the mapping of the kept rows off ties
    kept = np.nonzero([(p == jg["xyz"][:n_kept]).all(1).any() for p in pts])
    kept_clear = clear[kept[0]]
    jd, jf, ju = (np.asarray(x) for x in ja.mapping)
    d, f, u = (n(x) for x in ta.mapping)
    np.testing.assert_allclose(np.abs(d), np.abs(jd), atol=1e-5)
    np.testing.assert_allclose(d[kept_clear], jd[kept_clear], atol=1e-5)
    np.testing.assert_array_equal(f[kept_clear], jf[kept_clear])
    np.testing.assert_allclose(u[kept_clear], ju[kept_clear], atol=1e-5)


def test_repose(animators):
    """Given JAX's mapping (so that ties cannot decide it), the port's
    re-pose on its own meshes within 1e-5."""
    ja, ta, *_ = _bound(animators)
    d, f, u = (np.asarray(x) for x in ja.mapping)
    ta.mapping = (t(d), t(f, np.int64), t(u))
    del ta._mesh_at  # back to the port's own body forward, from frame 0
    ta.ori_center = None
    ta._mesh_at(0)
    for frame in (3, 5):
        ja.repose(frame)
        ta.repose(frame)
        np.testing.assert_allclose(n(ta.gaussians.xyz),
                                   np.asarray(ja.gaussians.xyz), atol=1e-5)


def _render_cfgs(backend):
    from gaussianip_tpu.render.render import RenderConfig as JCfg
    from gaussianip_tpu_torch.render.render import RenderConfig

    if backend == "reference":
        return JCfg(backend="reference"), RenderConfig(backend="reference")
    return (JCfg(backend="pallas", interpret=True, d_max=16,
                 depth_key="exact2", sort_stable=True, tri="highest",
                 table_gather="i32"),
            RenderConfig(d_max=16, depth_key="exact2", sort_stable=True))


def _close(got, ref, atol, name):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.quantile(d, 0.99) < atol, f"{name}: q99 {np.quantile(d, 0.99)}"
    assert d.max() < 100 * atol, f"{name}: max {d.max()}"


@pytest.mark.parametrize("backend", ["tiles", "reference"])
def test_render_frame(animators, backend):
    ja, ta, *_ = _bound(animators)
    jcfg, cfg = _render_cfgs(backend)
    for az in (0.0, 130.0):
        ref = ja.render_frame(az, height=64, width=64, render_cfg=jcfg)
        got = ta.render_frame(az, height=64, width=64, render_cfg=cfg)
        assert got.shape == (64, 64, 3) and 0 <= float(got.min())
        assert float(got.max()) <= 1.0 and ref.max() > 0.05
        _close(n(got), ref, 3e-4, f"rgb az {az}")


def test_render_motion(animators, tmp_path):
    """Three frames of playback with rotation, written as the video; uint8
    frames within the render tolerance plus one quantization step."""
    ja, ta, *_ = _bound(animators)
    jcfg, cfg = _render_cfgs("reference")
    kw = dict(play=True, rotate=True, height=64, width=64, max_frames=3)
    ref = ja.render_motion(str(tmp_path / "j.mp4"), render_cfg=jcfg, **kw)
    got = ta.render_motion(str(tmp_path / "t.mp4"), render_cfg=cfg, **kw)
    assert got.shape == ref.shape == (3, 64, 64, 3) and got.dtype == np.uint8
    _close(got / 255.0, ref / 255.0, 3e-4 + 1 / 255, "video")
    assert (os.path.exists(tmp_path / "t.mp4")
            or os.path.exists(tmp_path / "t.mp4.npy"))


def _cli_inputs(tmp_path, rng):
    p = str(tmp_path / "avatar.ply")
    _write_ply(p, rng, 300, 0)
    m = str(tmp_path / "walk.npz")
    np.savez(m, poses=_motion(rng))
    return p, m


def test_entry_point_cpu(tmp_path, rng):
    from gaussianip_tpu_torch.animation import main

    p, m = _cli_inputs(tmp_path, rng)
    out = main(["--ply", p, "--motion", m, "--stub-body", "--device", "cpu",
                "--W", "64", "--H", "64", "--max_frames", "3", "--play",
                "--rotate", "--save", str(tmp_path / "videos")])
    assert out == str(tmp_path / "videos" / "avatar_walk.mp4")
    if os.path.exists(out):
        assert os.path.getsize(out) > 0
    else:
        assert np.load(out + ".npy").shape == (3, 64, 64, 3)


def test_entry_point_needs_card_by_default(tmp_path, rng, monkeypatch):
    from gaussianip_tpu_torch.animation import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, m = _cli_inputs(tmp_path, rng)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--ply", p, "--motion", m, "--stub-body"])
