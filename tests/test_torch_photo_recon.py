"""The port's photo reconstruction (data/scene_readers.py,
system/photo_recon.py, model/densify.py:reset_opacity) against the JAX
package on the CPU.

Scenes are synthetic, written in the published layouts: a NeRF-synthetic
directory (transforms_{train,test}.json, PNG frames; one RGBA, one JPEG,
one missing) and a COLMAP workspace (sparse/0/*.bin with four camera
models). The readers are compared field by field, the image loader pixel
for pixel. The view ids of a step come from the JAX step's own key split
and go into the port's inner step; both render with the dense reference
compositor (backend "reference") at 64^2, so the two steps differ by
float32 rounding only. The schedule test runs both host loops with their
steps, densify and opacity reset replaced by recorders."""

import json
import os
import struct
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS, n, t, train_state_numpy

torch.set_num_threads(1)
RES = 64
N_VIEWS = 6
TOL = 1e-4


def _png(path, img):
    from gaussianip_tpu_torch.utils.saving import save_image

    save_image(str(path), img)


def _blender_dir(tmp_path, rng, res=16):
    """transforms_{train,test}.json with frames r_0 (RGB PNG at res^2),
    r_1 (RGBA PNG written by PIL, at res^2), r_2 (missing), r_3.jpg
    (12 x 20 JPEG) and r_4 (palette PNG at res^2)."""
    from PIL import Image

    d = tmp_path / "blender"
    os.makedirs(d)
    _png(d / "r_0.png", rng.integers(0, 256, (res, res, 3), dtype=np.uint8))
    rgba = rng.integers(0, 256, (res, res, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(d / "r_1.png")
    Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
                    ).save(d / "r_3.jpg")
    Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
                    ).convert("P").save(d / "r_4.png")
    for split, names in (("train", ["./r_0", "./r_1", "./r_2", "./r_3.jpg",
                                    "./r_4"]), ("test", ["./r_0"])):
        frames = []
        for name in names:
            m = np.eye(4)
            m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            m[:3, 3] = rng.normal(0, 2, 3)
            frames.append({"file_path": name,
                           "transform_matrix": m.tolist()})
        with open(d / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return str(d)


def _colmap_dir(tmp_path, rng):
    """sparse/0/{cameras,images,points3D}.bin: SIMPLE_PINHOLE, PINHOLE,
    SIMPLE_RADIAL and OPENCV cameras, an image each (ids out of order,
    with 2D points), 5 points with tracks."""
    d = tmp_path / "colmap"
    sparse = d / "sparse" / "0"
    os.makedirs(sparse)
    models = [(0, 64, 48), (1, 80, 60), (2, 32, 32), (4, 50, 40)]
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(models)))
        for cid, (model, w, h) in enumerate(models, 1):
            n_params = {0: 3, 1: 4, 2: 4, 4: 8}[model]
            f.write(struct.pack("<iiQQ", cid, model, w, h))
            params = rng.uniform(20, 90, n_params)
            f.write(struct.pack("<" + "d" * n_params, *params))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(models)))
        for iid, cid in zip((9, 3, 7, 5), (1, 2, 3, 4)):
            q = rng.normal(size=4)
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *(q / np.linalg.norm(q))))
            f.write(struct.pack("<ddd", *rng.normal(0, 2, 3)))
            f.write(struct.pack("<i", cid))
            f.write(f"img{iid}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 5))
        for i in range(5):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *rng.normal(size=3)))
            f.write(struct.pack("<BBB", *rng.integers(0, 256, 3)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 3))
            f.write(struct.pack("<ii", 1, 0) * 3)
    return str(d)


def _assert_scene_equal(got, want):
    assert len(got.cameras) == len(want.cameras)
    for a, b in zip(got.cameras, want.cameras):
        assert a.c2w.dtype == b.c2w.dtype
        np.testing.assert_array_equal(a.c2w, b.c2w)
        assert (a.fovy, a.fovx, a.image_path, a.width, a.height) == (
            b.fovy, b.fovx, b.image_path, b.width, b.height)
    for f in ("points", "colors"):
        if getattr(want, f) is None:
            assert getattr(got, f) is None
        else:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.nerf_normalization_radius == want.nerf_normalization_radius


@pytest.mark.parametrize("split", ["train", "test"])
def test_blender_reader(tmp_path, rng, split):
    """Field by field; the missing frame takes the 800 fallback, the JPEG
    its size through PIL."""
    from gaussianip_tpu.data import scene_readers as jsr
    from gaussianip_tpu_torch.data import scene_readers as sr

    d = _blender_dir(tmp_path, rng)
    got = sr.load_blender_scene(d, split=split)
    _assert_scene_equal(got, jsr.load_blender_scene(d, split=split))
    if split == "train":
        sizes = [(c.width, c.height) for c in got.cameras]
        assert sizes == [(16, 16), (16, 16), (800, 800), (20, 12), (16, 16)]


def test_colmap_reader_and_dispatch(tmp_path, rng):
    """Field by field for four camera models; load_scene picks the reader
    by the directory's layout, and raises where there is neither."""
    from gaussianip_tpu.data import scene_readers as jsr
    from gaussianip_tpu_torch.data import scene_readers as sr

    d = _colmap_dir(tmp_path, rng)
    got = sr.load_colmap_scene(d)
    _assert_scene_equal(got, jsr.load_colmap_scene(d))
    assert [os.path.basename(c.image_path) for c in got.cameras] == [
        "img3.png", "img5.png", "img7.png", "img9.png"]
    _assert_scene_equal(sr.load_scene(d), jsr.load_scene(d))
    b = _blender_dir(tmp_path, rng)
    _assert_scene_equal(sr.load_scene(b), jsr.load_scene(b))
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        sr.load_scene(str(tmp_path))


def test_load_images_equal(tmp_path, rng):
    """At the frames' own size (16^2): the port's PNG reader for the RGB and
    RGBA frames (alpha dropped), PIL for the palette PNG and the JPEG, a
    zero image for the missing frame; at 8^2 every frame through PIL's
    resize. Both equal to the JAX package's loader."""
    from gaussianip_tpu.data.scene_readers import load_blender_scene
    from gaussianip_tpu.system.photo_recon import _load_images as jload
    from gaussianip_tpu_torch.system.photo_recon import _load_images

    scene = load_blender_scene(_blender_dir(tmp_path, rng))
    for res in (16, 8):
        got = _load_images(scene, res)
        assert got.dtype == np.float32 and got.shape == (5, res, res, 3)
        np.testing.assert_array_equal(got, jload(scene, res))
    assert _load_images(scene, 16)[2].max() == 0.0


def test_load_images_without_pil(tmp_path, rng, monkeypatch):
    """Without PIL an 8-bit PNG at the training size still loads; a frame
    that needs a resample raises, naming the file and its size."""
    from gaussianip_tpu_torch.data.scene_readers import load_blender_scene
    from gaussianip_tpu_torch.system.photo_recon import _load_images

    scene = load_blender_scene(_blender_dir(tmp_path, rng))
    want = _load_images(scene._replace(cameras=scene.cameras[:3]), 16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = _load_images(scene._replace(cameras=scene.cameras[:3]), 16)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ImportError, match=r"r_0\.png \(16x16\).*PIL"):
        _load_images(scene, 8)


def test_init_from_scene_bit_identical(tmp_path, rng, monkeypatch):
    """A Blender scene (no points): the 100,000 random points and colours
    of np.random.default_rng(seed) and the state built from them equal the
    JAX package's bit for bit (the 3-NN distances, the same function in
    both, replaced by a constant to keep the test short); capacity
    max(cfg.capacity, 2 N)."""
    from gaussianip_tpu.data.scene_readers import load_blender_scene
    from gaussianip_tpu.system import photo_recon as jpr
    from gaussianip_tpu_torch.system import photo_recon as pr

    monkeypatch.setattr(jpr, "mean_dist2_3nn",
                        lambda p: jnp.full((p.shape[0],), 1e-4, jnp.float32))
    monkeypatch.setattr(pr, "mean_dist2_3nn",
                        lambda p: torch.full((p.shape[0],), 1e-4))
    scene = load_blender_scene(_blender_dir(tmp_path, rng))
    jts = jpr.init_from_scene(scene, jpr.PhotoReconConfig(capacity=4096), 7)
    ts = pr.init_from_scene(scene, pr.PhotoReconConfig(capacity=4096), 7,
                            device="cpu")
    g, jg = ts.gaussians, jts.gaussians
    assert g.capacity == jg.capacity == 200_000
    assert g.n_active == int(jg.n_active) == 100_000
    assert g.max_sh_degree == jg.max_sh_degree == 3
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(getattr(g, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def test_init_from_scene_points(tmp_path, rng):
    """A COLMAP scene's own points and colours, with the real 3-NN
    distances: scales within 1e-5."""
    from gaussianip_tpu.data.scene_readers import load_colmap_scene
    from gaussianip_tpu.system import photo_recon as jpr
    from gaussianip_tpu_torch.system import photo_recon as pr

    scene = load_colmap_scene(_colmap_dir(tmp_path, rng))
    jts = jpr.init_from_scene(scene, jpr.PhotoReconConfig(capacity=64))
    ts = pr.init_from_scene(scene, pr.PhotoReconConfig(capacity=64),
                            device="cpu")
    assert ts.gaussians.n_active == 5 and ts.gaussians.capacity == 64
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(n(getattr(ts.gaussians, f)),
                                   np.asarray(getattr(jts.gaussians, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_reset_opacity(rng):
    """Active opacities capped at 0.01, padding untouched, the opacity
    field's moments zeroed and the others kept."""
    from gaussianip_tpu.model.adam import init_adam
    from gaussianip_tpu.model.densify import reset_opacity as jreset
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.model.densify import reset_opacity
    from gaussianip_tpu_torch.system.stage1 import (TrainState,
                                                    train_state_from_numpy)

    from gaussianip_tpu.system.stage1 import init_train_state

    js = create_from_pcd(rng.normal(size=(20, 3)).astype(np.float32),
                         np.full((20, 3), 0.5, np.float32), 32,
                         rng.uniform(1e-3, 1e-2, 20).astype(np.float32))
    op = rng.uniform(-8, 4, (32, 1)).astype(np.float32)
    js = js.replace(opacity=jnp.asarray(op))
    opt = init_adam(js)
    mom = {f: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for f, v in opt.m.items()}
    opt = opt.replace(m=mom, v=jax.tree_util.tree_map(jnp.abs, mom))
    jts = init_train_state(js)._replace(opt=opt)
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    jg, jo = jreset(js, opt)
    g, o = reset_opacity(ts.gaussians, ts.opt)
    assert isinstance(ts, TrainState)
    np.testing.assert_allclose(n(g.opacity), np.asarray(jg.opacity),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(g.opacity[20:]), op[20:])
    assert float(g.get_opacity()[:20].max()) <= 0.01 + 1e-7
    for f in PARAM_FIELDS:
        for a, b in ((o.m, jo.m), (o.v, jo.v)):
            np.testing.assert_array_equal(n(a[f]), np.asarray(b[f]), f)
    assert not o.m["opacity"].any() and o.m["xyz"].any()


def _toy_scene(rng):
    """400 splats on a sphere as the ground truth, its 6 views rendered by
    the JAX reference compositor at 64^2 as the photos; the scene's points
    are the ground truth's, jittered. Returns (SceneInfo, images)."""
    from gaussianip_tpu.data.cameras import camera_from_c2w
    from gaussianip_tpu.data.scene_readers import SceneCamera, SceneInfo
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.camera_math import look_at_c2w
    from gaussianip_tpu.render.render import RenderConfig, render

    n_pts = 400
    v = rng.normal(size=(n_pts, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * 0.5).astype(np.float32)
    gt = create_from_pcd(pts, (v * 0.5 + 0.5).astype(np.float32), 512,
                         np.full(n_pts, 2e-3, np.float32))
    gt = gt.replace(opacity=jnp.full((512, 1), 2.0))
    az = np.linspace(0, 2 * np.pi, N_VIEWS, endpoint=False)
    eye = np.stack([2.0 * np.cos(az), 2.0 * np.sin(az),
                    np.full(N_VIEWS, 0.3)], 1)
    c2w = np.asarray(look_at_c2w(jnp.asarray(eye, jnp.float32),
                                 jnp.zeros((N_VIEWS, 3)),
                                 jnp.tile(jnp.array([[0.0, 0, 1]]),
                                          (N_VIEWS, 1))))
    cams = [SceneCamera(c2w[i], 0.9, 0.9, f"/nonexistent/{i}.png", RES, RES)
            for i in range(N_VIEWS)]
    jc = jax.vmap(lambda m: camera_from_c2w(m, jnp.float32(0.9), RES, RES))(
        jnp.asarray(c2w))
    imgs = np.asarray(render(gt, jc, jnp.zeros(3),
                             RenderConfig(backend="reference")).rgb)
    pts_j = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    return SceneInfo(cams, pts_j, np.full((n_pts, 3), 0.5, np.float32),
                     2.2), imgs


@pytest.fixture(scope="module")
def toy():
    """(scene, images, JAX TrainState): the scene's initial state with
    anisotropic scales, random rotations and SH rest coefficients, so that
    every field's gradient is well above rounding."""
    from gaussianip_tpu.system.photo_recon import (PhotoReconConfig,
                                                   init_from_scene)

    rng = np.random.default_rng(3)
    scene, imgs = _toy_scene(rng)
    cfg = PhotoReconConfig(resolution=RES, sh_degree=1, capacity=512)
    jts = init_from_scene(scene, cfg)
    g = jts.gaussians
    k = 400
    scaling = np.array(g.scaling)
    scaling[:k] += rng.uniform(-0.5, 0.5, (k, 3)).astype(np.float32)
    rotation = np.array(g.rotation)
    rotation[:k] = rng.normal(size=(k, 4)).astype(np.float32)
    f_rest = np.array(g.f_rest)
    f_rest[:k] = rng.normal(0, 0.2, (k, 3, 3)).astype(np.float32)
    jts = jts._replace(gaussians=g.replace(
        scaling=jnp.asarray(scaling), rotation=jnp.asarray(rotation),
        f_rest=jnp.asarray(f_rest)))
    return scene, imgs, jts


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_three_recon_steps_match(toy):
    """3 steps at 64^2, SH degree 1, backend "reference" in both, on the
    view ids of the JAX step's key split: loss, l1, psnr, every parameter
    field, Adam's moments and the densify statistics within 1e-4 of their
    largest |value|."""
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.render.render import RenderConfig as JRC
    from gaussianip_tpu.system.photo_recon import (PhotoReconConfig as JCfg,
                                                   make_recon_step as jmake)
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.photo_recon import (PhotoReconConfig,
                                                         make_inner_step,
                                                         scene_tensors)
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    scene, imgs, jts = toy
    jts = jax.tree_util.tree_map(jnp.array, jts)  # the JAX step donates it
    c2w = np.stack([c.c2w for c in scene.cameras])
    fovy = np.array([c.fovy for c in scene.cameras], np.float32)
    jstep = jmake(JCfg(resolution=RES, sh_degree=1, capacity=512),
                  JRC(backend="reference"), JAdam(spatial_lr_scale=2.2),
                  jnp.asarray(c2w), jnp.asarray(fovy), jnp.asarray(imgs), 1)
    c2ws, fovys = scene_tensors(scene, "cpu")
    inner = make_inner_step(
        PhotoReconConfig(resolution=RES, sh_degree=1, capacity=512),
        RenderConfig(backend="reference"), AdamHyper(spatial_lr_scale=2.2),
        c2ws, fovys, t(imgs), 1)
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    key = jax.random.PRNGKey(11)
    for i in range(3):
        _, k = jax.random.split(key)
        k_ids, _ = jax.random.split(k)
        ids = jax.random.choice(k_ids, N_VIEWS, (1,), replace=False)
        jts, jm, key = jstep(jts, key)
        ts, m = inner(ts, t(np.asarray(ids), np.int64))
        for k_ in ("loss", "l1", "psnr"):
            np.testing.assert_allclose(float(m[k_]), float(jm[k_]), rtol=TOL,
                                       err_msg=k_)
        assert m["n_active"] == int(jm["n_active"]) and ts.step == i + 1
        for f in PARAM_FIELDS:
            assert _rel(n(getattr(ts.gaussians, f)),
                        getattr(jts.gaussians, f)) <= TOL, (i, f)
            for mom in ("m", "v"):
                assert _rel(n(getattr(ts.opt, mom)[f]),
                            getattr(jts.opt, mom)[f]) <= TOL, (i, f, mom)
        for f in ("xyz_grad_accum", "denom", "max_radii2d"):
            assert _rel(n(getattr(ts.stats, f)),
                        getattr(jts.stats, f)) <= TOL, (i, f)
    assert float(ts.stats.denom.max()) == 3.0


def test_evaluate_matches(toy):
    """PSNR, SSIM and an LPIPS stand-in (mean |x - y| per image) over the 6
    views, backend "reference", within 1e-4; the state's own active SH
    degree (0) renders, as in the JAX package."""
    from gaussianip_tpu.render.render import RenderConfig as JRC
    from gaussianip_tpu.system.photo_recon import (PhotoReconConfig as JCfg,
                                                   evaluate as jeval)
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.photo_recon import (PhotoReconConfig,
                                                         evaluate)
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    scene, imgs, jts = toy
    want = jeval(jts, scene, JCfg(resolution=RES), JRC(backend="reference"),
                 images=imgs,
                 lpips_fn=lambda x, y: jnp.abs(x - y).mean(axis=(1, 2, 3)))
    got = evaluate(train_state_from_numpy(train_state_numpy(jts), "cpu"),
                   scene, PhotoReconConfig(resolution=RES),
                   RenderConfig(backend="reference"), images=imgs,
                   lpips_fn=lambda x, y: (x - y).abs().mean(dim=(1, 2, 3)))
    assert set(got) == {"psnr", "ssim", "lpips"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


class _Recorder:
    """Replaces a package's recon step, densify_and_prune and
    reset_opacity: records the iteration, the SH degree each step factory
    was built with, and each densify's world-size threshold."""

    def __init__(self):
        self.steps, self.events = 0, []

    def make_step(self, jax_side):
        def make(*args):
            self.events.append(("sh", self.steps, args[-1]))
            if jax_side:
                return lambda ts, key: (ts, {"loss": 0.0}, key)
            return lambda ts, gen: (ts, {"loss": 0.0})

        def counted(make_fn):
            def wrapped(*args):
                fn = make_fn(*args)

                def step(*a):
                    self.steps += 1
                    return fn(*a)
                return step
            return wrapped
        return counted(make)

    def densify(self, g, opt, stats, key, **kw):
        self.events.append(("densify", self.steps - 1,
                            round(kw["max_world_size"], 6),
                            kw["min_opacity"]))
        return g, opt, stats, 0

    def reset(self, g, opt):
        self.events.append(("reset", self.steps - 1))
        return g, opt


def test_train_schedule_matches(monkeypatch, toy):
    """Over 7,001 iterations of PhotoReconConfig()'s schedule: the SH
    raises before steps 1000, 2000, 3000, the densifies at 500..7000 (world
    threshold 1e9 up to the first reset, 0.1 x radius after it), the
    resets at 3000 and 6000, in the same order in both packages."""
    from gaussianip_tpu.system import photo_recon as jpr
    from gaussianip_tpu_torch.system import photo_recon as pr

    scene, imgs, _ = toy
    logs = {}
    for name, mod, jax_side in (("jax", jpr, True), ("port", pr, False)):
        rec = _Recorder()
        monkeypatch.setattr(mod, "make_recon_step", rec.make_step(jax_side))
        monkeypatch.setattr(mod, "densify_and_prune", rec.densify)
        monkeypatch.setattr(mod, "reset_opacity", rec.reset)
        if jax_side:  # the host loop's jits, undone so the recorders run
            monkeypatch.setattr(mod, "jax", types.SimpleNamespace(
                jit=lambda f: f, random=jax.random,
                device_get=jax.device_get))
        kw = {} if jax_side else {"device": "cpu"}
        mod.train_photo_recon(scene, mod.PhotoReconConfig(
            iterations=7001, resolution=RES, capacity=512), images=imgs,
            log_every=10 ** 6, **kw)
        logs[name] = rec.events
    assert logs["port"] == logs["jax"]
    ev = logs["port"]
    assert [e[1:] for e in ev if e[0] == "sh"] == [(0, 0), (1000, 1),
                                                   (2000, 2), (3000, 3)]
    dens = [e for e in ev if e[0] == "densify"]
    assert [e[1] for e in dens] == list(range(500, 7001, 100))
    assert {e[2] for e in dens if e[1] <= 3000} == {1e9}
    assert {e[2] for e in dens if e[1] > 3000} == {0.22}
    assert [e[1] for e in ev if e[0] == "reset"] == [3000, 6000]
