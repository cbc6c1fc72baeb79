"""Stage 3 of the port (diffusion/lpips.py, system/stage3.py) against the
JAX package on the CPU at tiny sizes, float32, on the same numpy inputs.
The step's view ids and the densify's split noise come from the JAX
functions' own key splits and go into the port as arguments.

The JAX side renders with the Pallas compositor in interpret mode, the
port with its tiled renderer (plain compositor on the CPU), both with exact
depth keys and a stable sort, as tests/test_torch_stage1.py does; the
tolerances of the state after a step are that file's (see
`_compare_states`). LPIPS: distances within 1e-4 of the largest, its
gradient to x within 1e-3 of the largest |gradient|; the converted
weights are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PARAM_FIELDS, assert_rel_close, n,
                           random_flax_params, t, train_state_numpy)

torch.set_num_threads(1)
RES = 64
N_VIEWS = 8
BS = 2
NARROW = ((8, 1), (16, 2))
MOM_TOL = {"m": 1e-2, "v": 2e-2}


def _lpips_pair(rng, stages, hw=(16, 16)):
    from gaussianip_tpu.diffusion.lpips import LPIPS as JL
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.lpips import LPIPS

    x = np.zeros((1, *hw, 3), np.float32)
    jm = JL(stages=stages)
    p = random_flax_params(jm, rng, x, x)
    return jm, p, from_flax(LPIPS(stages), p)


def test_lpips_narrow_matches_jax(rng):
    """Odd sizes: 37 x 29 pools (floored) to 18 x 14."""
    jm, p, m = _lpips_pair(rng, NARROW)
    x = rng.uniform(0, 1, (3, 37, 29, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (3, 37, 29, 3)).astype(np.float32)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(y))
    jg = jax.grad(lambda a: jnp.sum(jm.apply(p, a, jnp.asarray(y))
                                    * jnp.arange(1.0, 4.0)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    d = m(xt, t(y))
    assert d.shape == (3,)
    assert_rel_close(d, ref, 1e-4, "distance")
    (d * torch.arange(1.0, 4.0)).sum().backward()
    assert_rel_close(xt.grad, jg, 1e-3, "d/dx")
    with torch.no_grad():
        assert float(m(t(x), t(x)).abs().max()) < 1e-6


def test_convert_lpips_weights_and_full_vgg(rng):
    """torchvision vgg16 `features.*` and lpips `lin{i}.model.1.weight`
    dicts with random values: the port's conversion equals the JAX
    package's carried over by from_flax, and the VGG16-width LPIPS on
    those weights matches JAX's on a 32 x 32 pair."""
    from gaussianip_tpu.diffusion.lpips import LPIPS as JL
    from gaussianip_tpu.diffusion.lpips import convert_lpips_weights as jconv
    from gaussianip_tpu_torch.diffusion.from_flax import flax_state_dict
    from gaussianip_tpu_torch.diffusion.lpips import (VGG16_CONV_LAYERS,
                                                      VGG16_STAGES, LPIPS,
                                                      convert_lpips_weights)

    chans = [c for c, k in VGG16_STAGES for _ in range(k)]
    vgg, prev = {}, 3
    for tl, co in zip(VGG16_CONV_LAYERS, chans):
        vgg[f"features.{tl}.weight"] = (rng.normal(0, 1, (co, prev, 3, 3))
                                        / np.sqrt(9 * prev)).astype(
                                            np.float32)
        vgg[f"features.{tl}.bias"] = rng.normal(0, 0.1, co).astype(
            np.float32)
        prev = co
    lin = {f"lin{i}.model.1.weight": rng.uniform(0, 0.1, (1, c, 1, 1))
           .astype(np.float32) for i, (c, _) in enumerate(VGG16_STAGES)}
    jp = jconv(vgg, lin)
    sd = convert_lpips_weights(vgg, lin)
    ref_sd = flax_state_dict(jp)
    assert sorted(sd) == sorted(ref_sd)
    for k in sd:
        np.testing.assert_array_equal(n(sd[k]), n(ref_sd[k]), k)
    m = LPIPS()
    m.load_state_dict(sd, strict=True)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = JL().apply(jp, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        assert_rel_close(m(t(x), t(y)), ref, 1e-4, "distance")


@pytest.fixture(scope="module")
def stage3_pair():
    """A random splat scene (200 points, capacity 1024) as a JAX and a
    torch state, the 8-view refine orbit at 64^2, random targets of the
    crop window's half size, a narrow LPIPS, and both packages' configs
    (the crop window scaled to 64^2 as launch.py does)."""
    from _torch_parity import make_states
    from gaussianip_tpu.data.sampler import refine_orbit_batch as jorbit
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.render.render import RenderConfig as JRC
    from gaussianip_tpu.system.stage1 import init_train_state as jinit
    from gaussianip_tpu.system.stage3 import Stage3Config as JS3
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy
    from gaussianip_tpu_torch.system.stage3 import Stage3Config

    rng = np.random.default_rng(9)
    js, _ = make_states(rng, n_pts=200, capacity=1024, opacity=(-1.0, 2.0))
    jts = jinit(js)
    cy = (60 * RES // 1024, 890 * RES // 1024)
    cx = (220 * RES // 1024, 800 * RES // 1024)
    th, tw = (cy[1] - cy[0]) // 2, (cx[1] - cx[0]) // 2
    tgt = rng.uniform(0, 1, (N_VIEWS, th, tw, 3)).astype(np.float32)
    jl, lp, lm = _lpips_pair(rng, NARROW)
    cfg = dict(height=RES, width=RES, train_bs=BS, crop_y=cy, crop_x=cx,
               densify_at_global_step=2401)
    jside = (JS3(**cfg), JRC(backend="pallas", interpret=True, d_max=16,
                             depth_key="exact2", sort_stable=True,
                             tri="highest", table_gather="i32"), JAdam(),
             jorbit(N_VIEWS, 17.0, 1.5, 70.0, RES, RES), jnp.asarray(tgt),
             lambda a, b: jl.apply(lp, a, b))
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    pside = (Stage3Config(**cfg), RenderConfig(d_max=16, depth_key="exact2",
                                               sort_stable=True),
             AdamHyper(), refine_orbit_batch(N_VIEWS, 17.0, 1.5, 70.0, RES,
                                             RES, device="cpu"), t(tgt), lm)
    return (jts, jside), (ts, pside)


def _jax_ids(key):
    """The views of one JAX stage-3 step (system/stage3.py: k_ids, _ =
    split(key); choice without replacement)."""
    k_ids, _ = jax.random.split(key)
    return jax.random.choice(k_ids, N_VIEWS, (BS,), replace=False)


def _compare_states(ts, jts, steps, lrs):
    """As tests/test_torch_stage1.py: parameters, the 99th percentile of
    |diff| within 2e-2 of the field's lr and every entry within Adam's 2 lr
    per step (rotation: the bound only, its gradient being rounding noise
    on isotropic gaussians); Adam m within 1e-2, v within 2e-2 and the
    densify stats within 1e-2 of the field's largest |value|."""
    assert ts.gaussians.n_active == int(jts.gaussians.n_active)
    for f in PARAM_FIELDS:
        a, b = n(getattr(ts.gaussians, f)), np.asarray(
            getattr(jts.gaussians, f))
        if a.size == 0:
            continue
        d = np.abs(a - b)
        lr = float(lrs[f])
        if f != "rotation":
            assert np.quantile(d / lr, 0.99) <= 2e-2, f
        assert d.max() <= 2 * lr * steps + 1e-7, f
        for mom in ("m", "v") if f != "rotation" else ():
            a = n(getattr(ts.opt, mom)[f])
            b = np.asarray(getattr(jts.opt, mom)[f])
            tol = MOM_TOL[mom] * max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= tol, (f, mom)
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        a, b = n(getattr(ts.stats, f)), np.asarray(getattr(jts.stats, f))
        assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1e-30), f


def test_three_steps_match(stage3_pair):
    """make_stage3_step, 3 steps on the views the JAX step draws: loss, L1,
    LPIPS, the state, Adam's moments (the LR schedule from global step
    2400) and the densify stats from the viewspace offset's gradient."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage3 import make_stage3_step as jmake
    from gaussianip_tpu_torch.system.stage3 import make_stage3_step

    (jts, jside), (ts, pside) = stage3_pair
    jts = jax.tree_util.tree_map(jnp.array, jts)  # the JAX step donates it
    jstep = jmake(*jside[:5], lpips_fn=jside[5])
    step = make_stage3_step(*pside[:5], lpips_fn=pside[5])
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        ids = t(_jax_ids(key)).long()
        jts, jm = jstep(jts, key)
        ts, m = step(ts, ids)
        for k in ("loss", "l1", "lpips"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert float(m["lpips"]) > 0
        assert ts.step == int(jts.step) == i + 1
        _compare_states(ts, jts, i + 1, field_lrs(jside[2], 2400 + i))


def test_train_stage3_across_densify(stage3_pair):
    """train_stage3 for 3 steps with the densify after step index 1 (global
    2401 - 2400): every step's metrics and the final state, after the
    densify compacts both packages' states in the same order. The JAX loop
    with log_every 1 runs one step per key split and splits once more for
    the densify, whose split noise is normal(key, [2, CAP, 3])."""
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.system.stage3 import train_stage3 as jtrain
    from gaussianip_tpu_torch.system.stage3 import train_stage3

    (jts, jside), (ts, pside) = stage3_pair
    jts = jax.tree_util.tree_map(jnp.array, jts)
    key = jax.random.PRNGKey(7)
    ids, k = [], key
    for i in range(3):
        k, ki = jax.random.split(k)
        ids.append(np.asarray(_jax_ids(ki)))
        if i == 1:
            k, kd = jax.random.split(k)
    noise = jax.random.normal(kd, (2, jts.gaussians.capacity, 3))
    jlog, log = [], []
    ref = jtrain(jts, *jside[:5], key, lpips_fn=jside[5], n_steps=3,
                 log_every=1, log_fn=lambda i, m: jlog.append(m))
    got = train_stage3(ts, *pside[:5], t(np.stack(ids)).long(), t(noise),
                       lpips_fn=pside[5], log_every=1,
                       log_fn=lambda i, m: log.append(m))
    assert [m["n_active"] for m in log] == [int(m["n_active"])
                                            for m in jlog]
    assert log[1]["n_active"] == 200 != log[2]["n_active"]
    for m, jm in zip(log, jlog):
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-4)
    assert got.gaussians.n_active == int(ref.gaussians.n_active) != 200
    assert got.step == int(ref.step) == 3
    _compare_states(got, ref, 3, field_lrs(jside[2], 2402))


def test_build_random_lpips_vgg16_width():
    """The random LPIPS at VGG16 width: frozen, f32 parameters, linear
    heads not all zero; a distance of 0 between equal images, > 0 between
    different ones, and a gradient to x through the frozen network."""
    from gaussianip_tpu_torch.diffusion.lpips import VGG16_STAGES
    from gaussianip_tpu_torch.system.pipeline import build_random_lpips

    m = build_random_lpips(0, device="cpu")
    assert not any(p.requires_grad for p in m.parameters())
    for i, (ch, _) in enumerate(VGG16_STAGES):
        w = getattr(m, f"lin_{i}")
        assert w.shape == (ch,) and float(w.abs().sum()) > 0
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 37, 29, 3), generator=g, requires_grad=True)
    y = torch.rand((2, 37, 29, 3), generator=g)
    d = m(x, y)
    assert d.shape == (2,) and bool((d > 0).all())
    d.sum().backward()
    assert float(x.grad.abs().max()) > 0
    with torch.no_grad():
        assert float(m(y, y).abs().max()) < 1e-6
