"""The port's mesh modules (ops/mesh_extract.py, ops/mesh_export.py, the
covariance helpers of ops/transforms.py) and `python -m
gaussianip_tpu_torch.launch --export` against the JAX package on the CPU.

The density grid is a scatter-add, whose sums come in another order in the
two packages: grids are compared within 1e-5 of the grid's largest value,
marching tetrahedra runs on the JAX package's grid and must give the same
vertices and faces exactly, and the atlas and the bake (host numpy in both)
must be equal. The end-to-end export is compared on parsed numbers: the
faces and the atlas exactly, the vertices and the texture within
tolerances stated at each check."""

import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_numpy, n, t

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "exp.yaml")


def _ball(rng, n_pts=600, cap=1024):
    """A ball of anisotropic, rotated splats with random colours, as a JAX
    and a torch (CPU) GaussianState; every opacity above the 0.005 cut
    except a few."""
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy

    v = rng.normal(size=(n_pts, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    u = rng.uniform(0, 1, (n_pts, 1)) ** (1 / 3)
    pts = (v * u * 0.3 + [0.1, -0.2, 0.05]).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    js = create_from_pcd(pts, cols, cap, np.full(n_pts, 2e-3, np.float32))
    d = {f: np.array(a) for f, a in jax_state_numpy(js).items()}
    d["scaling"][:n_pts] += rng.uniform(-0.4, 0.4, (n_pts, 3))
    d["rotation"][:n_pts] = rng.normal(size=(n_pts, 4))
    d["opacity"][:n_pts] = rng.uniform(-1.0, 4.0, (n_pts, 1))
    d["opacity"][:8] = -7.0  # below the 0.005 cut
    js = js.replace(**{f: jnp.asarray(np.asarray(d[f], np.float32))
                       for f in ("scaling", "rotation", "opacity")})
    return js, state_from_numpy(jax_state_numpy(js), "cpu")


def test_covariance_helpers(rng):
    """build_scaling_rotation, build_covariance (with a scaling modifier)
    and strip_symmetric within 1e-6."""
    from gaussianip_tpu.ops import transforms as jtr
    from gaussianip_tpu_torch.ops import transforms as tr

    s = rng.uniform(0.01, 2.0, (50, 3)).astype(np.float32)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(n(tr.build_scaling_rotation(t(s), t(q))),
                               np.asarray(jtr.build_scaling_rotation(s, q)),
                               rtol=1e-6, atol=1e-6)
    cov = tr.build_covariance(t(s), t(q), 0.7)
    jcov = jtr.build_covariance(jnp.asarray(s), jnp.asarray(q), 0.7)
    np.testing.assert_allclose(n(cov), np.asarray(jcov), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(n(tr.strip_symmetric(t(np.asarray(jcov)))),
                                  np.asarray(jtr.strip_symmetric(jcov)))


def test_gaussian_3d_coeff(rng):
    """On random offsets and covariances within 1e-6; a singular covariance
    takes the 1e-24 determinant floor in both."""
    from gaussianip_tpu.ops.mesh_extract import gaussian_3d_coeff as jcoeff
    from gaussianip_tpu.ops.transforms import build_covariance
    from gaussianip_tpu_torch.ops.mesh_extract import gaussian_3d_coeff

    s = rng.uniform(0.05, 0.5, (64, 3)).astype(np.float32)
    s[0] = 0.0
    q = rng.normal(size=(64, 4)).astype(np.float32)
    c = np.asarray(build_covariance(jnp.asarray(s), jnp.asarray(q)))
    cov6 = np.stack([c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1],
                     c[:, 1, 2], c[:, 2, 2]], -1)
    d = rng.normal(0, 0.3, (64, 5, 3)).astype(np.float32)
    got = gaussian_3d_coeff(t(d), t(cov6)[:, None])
    want = jcoeff(jnp.asarray(d), jnp.asarray(cov6)[:, None])
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ball():
    return _ball(np.random.default_rng(5))


@pytest.fixture(scope="module")
def grids(ball):
    from gaussianip_tpu.ops.mesh_extract import extract_density_grid as jgrid
    from gaussianip_tpu_torch.ops.mesh_extract import extract_density_grid

    js, gs = ball
    return jgrid(js, 32, 8), extract_density_grid(gs, 32, 8)


def test_extract_density_grid(grids):
    """Resolution 32, patch 8: the grid within 1e-5 of its largest value
    (summation order), the normalisation exactly."""
    (jg, jc, js_), (g, c, s) = grids
    np.testing.assert_array_equal(c, jc)
    assert s == js_
    assert g.shape == (32, 32, 32) and jg.max() > 1.0
    assert np.abs(g - jg).max() <= 1e-5 * jg.max()


def test_splat_blocks_sum_alike(ball, monkeypatch):
    """Blocks of 7 gaussians give the single-block grid within 1e-6 of its
    largest value (the same sums in another order)."""
    from gaussianip_tpu_torch.ops import mesh_extract
    from gaussianip_tpu_torch.ops.mesh_extract import (normalized_splats,
                                                       splat_grid)

    s = normalized_splats(ball[1])
    one = splat_grid(s["xyz"], s["cov6"], s["opacity"], 24, 6)
    monkeypatch.setattr(mesh_extract, "SPLAT_BLOCK", 7)
    blocked = splat_grid(s["xyz"], s["cov6"], s["opacity"], 24, 6)
    assert float((one - blocked).abs().max()) <= 1e-6 * float(one.max())


@pytest.mark.parametrize("iso", [0.3, 1.0])
def test_marching_tetrahedra_equal(grids, iso):
    """On the JAX package's grid: the same vertices in the same order and
    the same faces."""
    from gaussianip_tpu.ops.mesh_extract import marching_tetrahedra as jmt
    from gaussianip_tpu_torch.ops.mesh_extract import marching_tetrahedra

    jg = grids[0][0]
    jv, jf = jmt(jg, iso)
    v, f = marching_tetrahedra(jg, iso)
    assert len(jf) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_marching_tetrahedra_empty():
    from gaussianip_tpu_torch.ops.mesh_extract import marching_tetrahedra

    v, f = marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 1.0)
    assert v.shape == (0, 3) and f.shape == (0, 3) and f.dtype == np.int32


def test_vertex_colors(ball, grids):
    """On the JAX package's mesh vertices: the colour grid within 1e-5 of
    its largest value and the vertex colours within 1e-5."""
    from gaussianip_tpu.ops.mesh_export import splat_color_grid as jcolor
    from gaussianip_tpu.ops.mesh_export import vertex_colors as jvc
    from gaussianip_tpu.ops.mesh_extract import extract_mesh as jmesh
    from gaussianip_tpu_torch.ops.mesh_export import (splat_color_grid,
                                                      vertex_colors)

    js, gs = ball
    jcg = jcolor(js, 32, 8)[0]
    cg = splat_color_grid(gs, 32, 8)[0]
    assert cg.shape == (32, 32, 32, 4)
    assert np.abs(cg - jcg).max() <= 1e-5 * jcg.max()
    verts, _ = jmesh(js, 32, 1.0)
    got = vertex_colors(gs, verts, resolution=32)
    want = jvc(js, verts, resolution=32)
    assert got.shape == (len(verts), 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n_faces,size", [(1, 64), (37, 256), (500, 1024)])
def test_pack_and_bake_equal(rng, n_faces, size):
    from gaussianip_tpu.ops.mesh_export import bake_texture as jbake
    from gaussianip_tpu.ops.mesh_export import pack_face_uvs as jpack
    from gaussianip_tpu_torch.ops.mesh_export import (bake_texture,
                                                      pack_face_uvs)

    uv, spec = pack_face_uvs(n_faces, size)
    juv, jspec = jpack(n_faces, size)
    np.testing.assert_array_equal(uv, juv)
    for k, v in jspec.items():
        np.testing.assert_array_equal(spec[k], v, err_msg=k)
    cols = rng.uniform(0, 1, (n_faces, 3, 3))
    np.testing.assert_array_equal(bake_texture(cols, spec),
                                  jbake(cols, jspec))


def _read_texture(path):
    from gaussianip_tpu_torch.utils.saving import read_png

    if path.endswith(".npy"):  # the JAX package without OpenCV
        return np.load(path)
    return read_png(path)


def test_obj_mtl_text_equal(tmp_path, rng):
    """The same vertices, faces and colours give the same OBJ and MTL text
    and the same texture pixels (the JAX package's OpenCV PNG or .npy, the
    port's own PNG)."""
    from gaussianip_tpu.ops.mesh_export import export_textured_obj as jexp
    from gaussianip_tpu_torch.ops.mesh_export import export_textured_obj

    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, (61, 3)).astype(np.int32)
    cols = rng.uniform(0, 1, (40, 3))
    jp = jexp(str(tmp_path / "jax" / "m"), verts, faces, cols, 128)
    p = export_textured_obj(str(tmp_path / "port" / "m"), verts, faces, cols,
                            128)
    assert p["texture"].endswith("m_albedo.png")
    for k in ("obj", "mtl"):
        assert open(p[k]).read() == open(jp[k]).read(), k
    np.testing.assert_array_equal(_read_texture(p["texture"]),
                                  _read_texture(jp["texture"]))


def test_export_avatar_mesh_plain_and_empty(tmp_path, ball):
    """fmt "obj" writes a plain OBJ equal to the JAX package's on parsed
    numbers; a threshold above the field raises ValueError."""
    from gaussianip_tpu.ops.mesh_export import export_avatar_mesh as jexp
    from gaussianip_tpu_torch.ops.mesh_export import export_avatar_mesh

    js, gs = ball
    p = export_avatar_mesh(gs, str(tmp_path / "p"), 24, 1.0, fmt="obj")
    jp = jexp(js, str(tmp_path / "j"), 24, 1.0, fmt="obj")
    assert set(p) == {"obj"}
    (v, f), (jv, jf) = _parse_obj(p["obj"]), _parse_obj(jp["obj"])
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-4)
    with pytest.raises(ValueError, match="no surface"):
        export_avatar_mesh(gs, str(tmp_path / "e"), 24, 1e9)


def _parse_obj(path):
    v, f, vt = [], [], []
    for ln in open(path):
        tok = ln.split()
        if not tok:
            continue
        if tok[0] == "v":
            v.append([float(x) for x in tok[1:]])
        elif tok[0] == "vt":
            vt.append([float(x) for x in tok[1:]])
        elif tok[0] == "f":
            f.append([x for x in tok[1:]])
    return (np.array(v), np.array(f)) if not vt else (np.array(v),
                                                     np.array(f),
                                                     np.array(vt))


EXPORT_OVERRIDES = ["system.exporter.resolution=32",
                    "system.exporter.density_thresh=0.5",
                    "system.exporter.texture_size=128"]


def test_launch_export_matches_root_launch(tmp_path, ball):
    """`python -m gaussianip_tpu_torch.launch --export --device cpu
    --resume_from <ply>` against the root launch.py's run_export on the same
    .ply: the manifest's export entry names an OBJ, MTL and PNG; faces,
    texture coordinates and the MTL text equal; vertices within 1e-5 (the
    grids' summation order, printed at :.6f); texture pixels within one
    level (vertex colours from those grids, rounded to uint8)."""
    sys.path.insert(0, ROOT)
    import launch as root_launch
    from gaussianip_tpu.utils.config import load_config
    from gaussianip_tpu.utils.saving import RunDirs
    from gaussianip_tpu_torch import launch
    from gaussianip_tpu_torch.model.ply import state_to_ply

    ply = str(tmp_path / "avatar.ply")
    state_to_ply(ball[1], ply)
    log = str(tmp_path / "logs")
    launch.main(["--config", CONFIG, "--cur_time", "port", "--export",
                 "--device", "cpu", "--resume_from", ply,
                 f"system.log_path={log}", *EXPORT_OVERRIDES])
    with open(os.path.join(log, "port", "run.json")) as fh:
        got = json.load(fh)["export"]
    assert set(got) == {"obj", "mtl", "texture"}
    assert got["obj"] == os.path.join(log, "port", "export", "model.obj")
    assert got["texture"].endswith("model_albedo.png")

    cfg = load_config(CONFIG, f"system.log_path={log}", *EXPORT_OVERRIDES)
    dirs = RunDirs(log, "jax")
    want = root_launch.run_export(cfg, dirs, types.SimpleNamespace(
        resume_from=ply))
    (v, f, vt), (jv, jf, jvt) = _parse_obj(got["obj"]), _parse_obj(
        want["obj"])
    assert len(f) > 100
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_allclose(v, jv, atol=1e-5)
    assert open(got["mtl"]).read() == open(want["mtl"]).read()
    d = np.abs(_read_texture(got["texture"]).astype(np.int32)
               - _read_texture(want["texture"]).astype(np.int32))
    assert d.max() <= 1


def test_launch_export_needs_a_ply(tmp_path):
    """Without --resume_from, a final_ply or save/last.ply: the JAX
    package's FileNotFoundError."""
    from gaussianip_tpu_torch import launch

    with pytest.raises(FileNotFoundError, match="--export needs a trained"):
        launch.main(["--config", CONFIG, "--cur_time", "x", "--export",
                     "--device", "cpu", f"system.log_path={tmp_path}"])
