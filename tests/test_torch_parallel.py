"""Data parallel in the port (gaussianip_tpu_torch/parallel/mesh.py and the
`group` paths of stages 1, 2 and 3) against the JAX package's 2-device
mesh (`mesh=make_data_mesh(2)`, on conftest's virtual CPU devices) and
against the port's single process, on the same injected inputs: the JAX
step's own camera batches, guidance draws, view ids, densify noise and
refine noise, as the single-process parity tests feed them.

The port's ranks are 2 gloo processes on the CPU that one spawn starts for
every case (tests/_torch_dp_ranks.py holds what they run); a second spawn
shows that a rank that raises fails the spawn. Each rank's state is
checked bit-equal to the other's inside the ranks (check_replicated). The
same spawn holds that launch gives every rank rank 0's face identity.

Tolerances. Against the port's single process after one step (f32, the
same arithmetic with its sums reassociated over the ranks): losses to
1e-6 relative; Adam m and v and the densify statistics to 1e-5 of the
field's largest |value|; radii and denominators exact; parameters within
1e-3 of the field's lr at the 99th percentile and within Adam's 2 lr a
step everywhere (an entry whose gradient is rounding noise may step either
way). The guided step's networks run at half the batch on each rank, and
the CPU's convolutions block by batch: its loss to 2e-5, its moments and
statistics to 1e-3. From the second step on, a parameter a rounding apart can put a
pixel on the other side of the alpha and transmittance gates, so the
comparison takes the single-process parity tests' tolerances, which also
hold the port against the JAX mesh (tests/test_torch_stage1.py,
test_torch_stage3.py; the loss to 1e-4 relative). The refined views: 1e-5
against the single process (the dense groups' UNet batch halves), 1e-4
against JAX, as tests/test_torch_refine.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_ranks as R
from _torch_parity import (PARAM_FIELDS, jax_draws, make_states, n,
                           random_flax_params, stage1_scene, t,
                           tiny_guidance_pair, train_state_numpy)

torch.set_num_threads(1)
H = W = 32
B = 2
GH = 64  # the guided case's renders
RES3, VIEWS3, BS3 = 64, 8, 2
IMG = 16  # the refine's images (8 x 8 latents)
MOM_TOL = {"m": 1e-2, "v": 2e-2}


def _jax_render_cfg():
    from gaussianip_tpu.render.render import RenderConfig as JRender

    return JRender(backend="pallas", interpret=True, d_max=16,
                   depth_key="exact2", sort_stable=True, tri="highest",
                   table_gather="i32")


def _render_cfg():
    from gaussianip_tpu_torch.render.render import RenderConfig

    return RenderConfig(d_max=16, depth_key="exact2", sort_stable=True)


def _mesh():
    from gaussianip_tpu.parallel.mesh import make_data_mesh

    return make_data_mesh(2)


def _stage1_cfgs(h, w):
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCam
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.system.stage1 import Stage1Config as JS1
    from gaussianip_tpu_torch.data.sampler import CameraSamplerConfig
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.system.stage1 import Stage1Config

    s1 = dict(render_height=h, render_width=w)
    cam = dict(height=h, width=w, batch_size=B, head_start_step=0,
               back_start_step=0)
    return ((JS1(**s1), JCam(**cam), JAdam(), _jax_render_cfg()),
            (Stage1Config(**s1), CameraSamplerConfig(**cam), AdamHyper(),
             _render_cfg()))


def _port_batch(jb):
    from gaussianip_tpu_torch.data.sampler import CameraBatch

    return CameraBatch(*(t(x) for x in jb))


def _rank1_max_keys(sk, jts, jcam, count):
    """JAX keys whose camera batch puts the batch's depth max in view 1
    (rank 1's), strictly above view 0's: the port's render of the state."""
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w
    from gaussianip_tpu_torch.render.render import render
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    g = train_state_from_numpy(train_state_numpy(jts), "cpu").gaussians
    keys = []
    for k in range(10, 60):
        key = jax.random.PRNGKey(k)
        jb = _port_batch(jsample(jcam, jax.random.split(key)[0], 0))
        with torch.no_grad():
            d = render(g, camera_from_c2w(jb.c2w, jb.fovy, H, W),
                       torch.zeros(3), _render_cfg()).depth
        per_view = d.flatten(1).amax(1)
        if per_view[1] > per_view[0]:
            keys.append(key)
        if len(keys) == count:
            return keys
    raise AssertionError("no key puts the depth max in view 1")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's inputs: the JAX side's objects and the cases the ranks
    run (numpy and torch objects only: the ranks import no JAX)."""
    from gaussianip_tpu.data.sampler import refine_orbit_batch as jorbit
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu.guidance.stub import make_stub_guidance as jstub
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.system import refine as jr
    from gaussianip_tpu.system.stage1 import init_train_state as jinit
    from gaussianip_tpu.system.stage3 import Stage3Config as JS3
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.lpips import LPIPS
    from gaussianip_tpu_torch.guidance.stub import make_stub_guidance
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.system import refine as pr
    from gaussianip_tpu_torch.system.stage3 import Stage3Config

    sk, jts = stage1_scene()
    out = {"sk": sk, "jts": jts}
    # (1) the row split and the collectives: 4 rows, 3 depths a rank
    out["x"] = np.arange(12, dtype=np.float32).reshape(4, 3)
    out["depth"] = np.array([[1.0, 5.0, 2.0], [5.0, 3.0, 5.0]], np.float32)
    # (2) stub-guided steps whose depth max lies in rank 1's view, then a
    # densify; a step whose two views are one camera (the max tied across
    # the ranks)
    jc, pc = _stage1_cfgs(H, W)
    tgt = np.zeros((H, W, 3), np.float32)
    tgt[8:24, 8:24] = 0.8
    out["stub_keys"] = _rank1_max_keys(sk, jts, jc[1], 2)
    out["stub_guidance"] = jstub(jnp.asarray(tgt), 0.01)
    steps = []
    for key in out["stub_keys"]:
        k_cam, k_guid = jax.random.split(key)
        steps.append((_port_batch(jsample(jc[1], k_cam, len(steps))),
                      t(jax.random.normal(k_guid, (B, H, W, 3)))))
    dkw = dict(max_grad=1e-7, min_opacity=pc[0].densify_prune_min_opacity,
               extent=pc[0].cameras_extent,
               max_world_size=pc[0].densify_prune_world_size_threshold)
    out["densify_key"], out["densify_kw"] = jax.random.PRNGKey(5), dkw
    noise = t(jax.random.normal(out["densify_key"],
                                (2, jts.gaussians.capacity, 3)))
    state_np = train_state_numpy(jts)
    stub = make_stub_guidance(tgt, 0.01)
    b0 = steps[0][0]
    tied = (type(b0)(*(x[:1].repeat_interleave(2, 0) for x in b0)),
            steps[0][1][:1].repeat_interleave(2, 0))
    cases = {
        "collectives": ("collectives", (t(out["x"]), t(out["depth"]))),
        "stub": ("stage1", (state_np, sk.points3d, pc, stub, steps,
                            (noise, dkw))),
        "tied": ("stage1", (state_np, sk.points3d, pc, stub, [tied])),
    }
    # (3) the tiny AHDS guidance at 64^2: the global-B sds_loss
    jg, g = tiny_guidance_pair(np.random.default_rng(31), image_size=GH)
    jgc, pgc = _stage1_cfgs(GH, GH)
    out["guided"] = (jg, jgc)
    k_cam, k_guid = jax.random.split(jax.random.PRNGKey(40))
    gsteps = [(_port_batch(jsample(jgc[1], k_cam, 0)),
               jax_draws(k_guid, B, GH // 2))]
    cases["guided"] = ("stage1", (state_np, sk.points3d, pgc, g, gsteps))
    # (4) stage 3 with the tiny LPIPS: 8 refine views at 64^2
    rng = np.random.default_rng(9)
    js, _ = make_states(rng, n_pts=200, capacity=1024, opacity=(-1.0, 2.0))
    cy = (60 * RES3 // 1024, 890 * RES3 // 1024)
    cx = (220 * RES3 // 1024, 800 * RES3 // 1024)
    th, tw = (cy[1] - cy[0]) // 2, (cx[1] - cx[0]) // 2
    tgt3 = rng.uniform(0, 1, (VIEWS3, th, tw, 3)).astype(np.float32)
    narrow = ((8, 1), (16, 2))
    from gaussianip_tpu.diffusion.lpips import LPIPS as JL

    jl = JL(stages=narrow)
    x0 = np.zeros((1, 16, 16, 3), np.float32)
    lp = random_flax_params(jl, rng, x0, x0)
    s3 = dict(height=RES3, width=RES3, train_bs=BS3, crop_y=cy, crop_x=cx,
              densify_at_global_step=2401)
    jts3 = jinit(js)
    out["stage3"] = (jts3, (JS3(**s3), _jax_render_cfg(), JAdam(),
                            jorbit(VIEWS3, 17.0, 1.5, 70.0, RES3, RES3),
                            jnp.asarray(tgt3)), lambda a, b: jl.apply(lp, a,
                                                                       b))
    keys3 = [jax.random.PRNGKey(20 + i) for i in range(2)]
    out["stage3_keys"] = keys3
    ids = t(np.stack([np.asarray(jax.random.choice(
        jax.random.split(k)[0], VIEWS3, (BS3,), replace=False))
        for k in keys3])).long()
    cases["stage3"] = ("stage3", (
        train_state_numpy(jts3),
        (Stage3Config(**s3), _render_cfg(), AdamHyper()),
        refine_orbit_batch(VIEWS3, 17.0, 1.5, 70.0, RES3, RES3,
                           device="cpu"), t(tgt3),
        from_flax(LPIPS(narrow), lp).requires_grad_(False), ids))
    # (5) refine_views at dense_batch 8 with the tiny stack at 16^2
    rng = np.random.default_rng(5)
    jgr, gr = tiny_guidance_pair(rng, image_size=IMG)
    imgs = rng.uniform(0, 1, (32, IMG, IMG, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 1, (32, IMG, IMG, 3)).astype(np.float32)
    ctxs = {v: (0.5 * rng.normal(0, 1, (2, 81, 32))).astype(np.float32)
            for v in jr.VIEW_NAME_ALL}
    rkey = jax.random.PRNGKey(3)
    rnoise = jax.random.normal(jax.random.split(rkey)[0],
                               (IMG // 2, IMG // 2, 4))
    out["refine"] = (jr.RefineModels(*jgr.models), imgs, ctrl, ctxs, rkey)
    cases["refine"] = ("refine", (
        pr.RefineModels(*gr.models), t(imgs), t(ctrl),
        {k: t(v) for k, v in ctxs.items()}, t(rnoise).permute(2, 0, 1), 8))
    # the face identity on insightface's fallback: two random PNGs
    from gaussianip_tpu_torch.utils.saving import save_image

    faces = []
    for i in range(2):
        faces.append(str(tmp_path_factory.mktemp("faces") / f"{i}.png"))
        save_image(faces[-1], rng.uniform(0, 1, (48, 40, 3)))
    cases["face_identity"] = ("face_identity", tuple(faces))
    out["cases"] = cases
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """[rank 0's, rank 1's] results of every case, from one spawn."""
    from gaussianip_tpu_torch.parallel.mesh import spawn

    return spawn(2, R.run_cases, inputs["cases"], timeout_s=300)


def _single(inputs, name):
    """The port's single-process run of a case."""
    fn, args = inputs["cases"][name]
    return getattr(R, fn)(None, *args)


def _close_states(got, ref, lrs, steps, q_tol, mom_tol):
    """Parameters: the 99th percentile of |diff| within q_tol of the
    field's lr and every entry within 2 lr a step (rotation: the bound
    only); Adam m / v and the densify stats within mom_tol (a dict) of the
    field's largest |value| (rotation's moments, rounding noise on
    isotropic gaussians, are not compared); equal counts."""
    gref = ref.gaussians
    assert got.gaussians.n_active == int(gref.n_active)
    assert got.step == int(ref.step)
    for f in PARAM_FIELDS:
        a, b = n(getattr(got.gaussians, f)), np.asarray(getattr(gref, f))
        if a.size == 0:
            continue
        d = np.abs(a - b)
        lr = float(lrs[f])
        if f != "rotation":
            assert np.quantile(d / lr, 0.99) <= q_tol, f
        assert d.max() <= 2 * lr * steps + 1e-7, f
        for mom in ("m", "v") if f != "rotation" else ():
            a = n(getattr(got.opt, mom)[f])
            b = np.asarray(getattr(ref.opt, mom)[f])
            tol = mom_tol[mom] * max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= tol, (f, mom)
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        a, b = n(getattr(got.stats, f)), np.asarray(getattr(ref.stats, f))
        tol = mom_tol["m"] * max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= tol, f


def _close_to_single(got, single, lrs, loss_tol=1e-6, mom_tol=1e-5):
    """The ranks' run against the single process's: step 1 to the
    reassociation tolerances (loss_tol relative on the metrics, mom_tol of
    the largest |value| on the moments and statistics), later steps to the
    parity tests'."""
    for i, (a, b) in enumerate(zip(got["metrics"], single["metrics"])):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=loss_tol if i == 0
                                       else 1e-4, err_msg=k)
    first, ref = got["states"][0], single["states"][0]
    _close_states(first, ref, lrs, 1, 1e-3, {"m": mom_tol, "v": mom_tol})
    for f in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(n(getattr(first.stats, f)),
                                      n(getattr(ref.stats, f)))
    for i in range(1, len(got["states"])):
        _close_states(got["states"][i], single["states"][i], lrs, i + 1,
                      2e-2, MOM_TOL)


def _same_on_ranks(ranks, name):
    """Both ranks returned the same state digest and metrics."""
    a, b = ranks[0][name], ranks[1][name]
    assert torch.equal(a["digest"], b["digest"]), name
    assert a["metrics"] == b["metrics"], name


def test_row_split_and_collectives(inputs, ranks):
    """Each rank's rows, span and collectives against numpy; global_max's
    value and gradient with the max tied across ranks (rank r scales the
    max by r + 1: each of the 3 tied elements gets (1 + 2) / 3);
    check_replicated raises on every rank when they differ."""
    x, depth = inputs["x"], inputs["depth"]
    mine = [x + 1, x + 2]
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(n(c["rows"]), x[2 * r:2 * r + 2])
        assert c["span"] == ((0, 2), (2, 5))[r]
        np.testing.assert_array_equal(n(c["sum"]), mine[0] + mine[1])
        np.testing.assert_array_equal(n(c["max"]), np.maximum(*mine))
        np.testing.assert_array_equal(n(c["imax"]), (mine[1] * 10).astype(
            np.int32))
        np.testing.assert_array_equal(n(c["any"]), mine[1][:, 0] > 5.5)
        np.testing.assert_array_equal(n(c["many"][0]), mine[0] + mine[1])
        np.testing.assert_array_equal(n(c["many"][1]),
                                      (mine[0] + mine[1])[:, 0])
        np.testing.assert_array_equal(n(c["gather"]), np.repeat(
            [[0.0], [0.0], [1.0], [1.0], [1.0]], 2, 1))
        np.testing.assert_array_equal(n(c["bcast"]["a"]), mine[0])
        np.testing.assert_array_equal(n(c["bcast"]["b"][0]), mine[0][0])
        assert float(c["gmax"]) == depth.max() == 5.0
        np.testing.assert_array_equal(n(c["gmax_grad"]),
                                      (depth[r] == 5.0) * 1.0)
        assert "['.x']" in c["bad"]


def test_stage1_stub_steps(inputs, ranks):
    """Two stub-guided steps whose depth max lies in rank 1's view: the
    loss and the state after each against the JAX 2-device mesh and the
    port's single process. A rank-local max (or a gradient to each rank's
    own argmax) changes rank 0's depth normalisation and its gradient."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage1 import make_train_step as jmake

    _same_on_ranks(ranks, "stub")
    got = ranks[0]["stub"]
    sk = inputs["sk"]
    (js1, jcam, jadam, jrcfg), _ = _stage1_cfgs(H, W)
    jstep = jmake(js1, jcam, jrcfg, jadam, inputs["stub_guidance"],
                  sk.points3d, mesh=_mesh())
    jts = jax.tree_util.tree_map(jnp.array, inputs["jts"])
    jm = []
    for key in inputs["stub_keys"]:
        jts, m = jstep(jts, key)
        jm.append(float(m["loss"]))
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], jm,
                               rtol=1e-4)
    lrs = field_lrs(jadam, 0)
    _close_states(got["ts"], jts, lrs, 2, 2e-2, MOM_TOL)
    _close_to_single(got, _single(inputs, "stub"), lrs)
    inputs["jts_after_stub"] = jts


def test_stage1_depth_max_tied_across_ranks(inputs, ranks):
    """One step whose two views are the same camera, so that the depth
    max ties across the ranks: the loss and the state as in one process.
    (Equal counts on both ranks split the gradient alike either way; the
    split over unequal counts is test_row_split_and_collectives'.)"""
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.model.adam import field_lrs

    _same_on_ranks(ranks, "tied")
    _close_to_single(ranks[0]["tied"], _single(inputs, "tied"),
                     field_lrs(JAdam(), 0))


def test_stage1_guided_steps(inputs, ranks):
    """A step of the tiny AHDS guidance: each rank's sds_loss divides by
    the whole batch's B, so the loss, loss_sds and the state match the JAX
    mesh and the single process; grad_norm and t_mean are the whole
    batch's."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage1 import make_train_step as jmake

    _same_on_ranks(ranks, "guided")
    got = ranks[0]["guided"]
    jg, (js1, jcam, jadam, jrcfg) = inputs["guided"]
    jstep = jmake(js1, jcam, jrcfg, jadam, jg, inputs["sk"].points3d,
                  mesh=_mesh())
    jts = jax.tree_util.tree_map(jnp.array, inputs["jts"])
    jts, jm = jstep(jts, jax.random.PRNGKey(40))
    for k in ("loss", "loss_sds"):
        np.testing.assert_allclose(got["metrics"][0][k], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    _close_states(got["ts"], jts, field_lrs(jadam, 0), 1, 2e-2, MOM_TOL)
    assert {"grad_norm", "t_mean"} <= got["metrics"][0].keys()
    _close_to_single(got, _single(inputs, "guided"), field_lrs(jadam, 0),
                     loss_tol=2e-5, mom_tol=1e-3)


def test_stage3_steps(inputs, ranks):
    """Two stage-3 steps with the tiny LPIPS: the global L1 and LPIPS
    means, the loss and the state against the JAX mesh and the single
    process."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage3 import make_stage3_step as jmake

    _same_on_ranks(ranks, "stage3")
    got = ranks[0]["stage3"]
    jts, jside, jlp = inputs["stage3"]
    jstep = jmake(*jside, lpips_fn=jlp, mesh=_mesh())
    jts = jax.tree_util.tree_map(jnp.array, jts)
    for i, key in enumerate(inputs["stage3_keys"]):
        jts, jm = jstep(jts, key)
        for k in ("loss", "l1", "lpips"):
            np.testing.assert_allclose(got["metrics"][i][k], float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    lrs = field_lrs(jside[2], 2401)
    _close_states(got["ts"], jts, lrs, 2, 2e-2, MOM_TOL)
    _close_to_single(got, _single(inputs, "stage3"), lrs)


def test_refine_views_dense_batch_8(inputs, ranks):
    """refine_views at dense_batch 8, one step: the anchors and keys whole
    on each rank, each dense group of 8 split 4 + 4, the VAE split 16 +
    16. Against the JAX mesh's (atol 1e-4 on [0, 1] images, as the
    single-process test) and the port's single process (1e-5)."""
    from gaussianip_tpu.system.refine import refine_views as jrefine

    got = ranks[0]["refine"]
    assert torch.equal(got["images"], ranks[1]["refine"]["images"])
    assert got["phases"] == ["encode", "anchors", "keys"] + ["dense"] * 3 \
        + ["decode"]
    jm, imgs, ctrl, ctxs, key = inputs["refine"]
    ref = np.asarray(jrefine(jm, jnp.asarray(imgs), jnp.asarray(ctrl),
                             {k: jnp.asarray(v) for k, v in ctxs.items()},
                             key, num_steps=1, dense_batch=8, mesh=_mesh()))
    assert ((ref > 0) & (ref < 1)).mean() > 0.2
    np.testing.assert_allclose(n(got["images"]), ref, rtol=0, atol=1e-4)
    single = _single(inputs, "refine")
    np.testing.assert_allclose(n(got["images"]), n(single["images"]),
                               rtol=0, atol=1e-5)


def test_states_equal_after_densify(inputs, ranks):
    """After the stub steps, a densify_and_prune with the JAX key's split
    noise on every rank: the ranks' states are bit-equal (checked in the
    ranks and by their digests), and the state matches the JAX package's
    densify of its mesh-trained state and the single process's."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.model.densify import densify_and_prune as jdens

    if "jts_after_stub" not in inputs:
        test_stage1_stub_steps(inputs, ranks)
    got = ranks[0]["stub"]["densified"]
    assert torch.equal(ranks[0]["stub"]["digest"],
                       ranks[1]["stub"]["digest"])
    jts = inputs["jts_after_stub"]
    g, opt, stats, _ = jdens(jts.gaussians, jts.opt, jts.stats,
                             inputs["densify_key"], **inputs["densify_kw"])
    assert got.gaussians.n_active == int(g.n_active) != 400
    ref = jts._replace(gaussians=g, opt=opt, stats=stats)
    lrs = field_lrs(_stage1_cfgs(H, W)[0][2], 0)
    _close_states(got, ref, lrs, 2, 2e-2, MOM_TOL)
    single = _single(inputs, "stub")["densified"]
    _close_states(got, single, lrs, 2, 2e-2, MOM_TOL)


def test_rank_that_raises_fails_spawn():
    """A rank that raises makes spawn raise, while the other waits in a
    collective."""
    from gaussianip_tpu_torch.parallel.mesh import spawn

    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn(2, R.fail_on_rank1, timeout_s=60)


def test_face_identity_is_rank_0s(inputs, ranks):
    """Without insightface the face embedding is seeded by Python's str
    hash, which each process salts anew (unless PYTHONHASHSEED is set):
    launch gives every rank rank 0's embedding and crops."""
    a, b = ranks[0]["face_identity"], ranks[1]["face_identity"]
    flat = lambda faces: [x for pair in faces for x in pair]
    for x, y, own in zip(flat(a["launch"]), flat(b["launch"]),
                         flat(a["own"])):
        np.testing.assert_array_equal(x, own)
        np.testing.assert_array_equal(y, own)
    if "PYTHONHASHSEED" not in os.environ:
        assert not np.array_equal(a["own"][0][0], b["own"][0][0])
