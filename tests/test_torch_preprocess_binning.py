"""Parity of the port's projection and tile binning with the JAX package.

Projection: float fields to 1e-5 relative (same scalar formulas), integer
radii and validity exactly. Binning is fed the JAX projection, so both sides
bin identical inputs: per-tile instance SETS and n_dropped must be equal
under every depth key, and under the exact depth key ("exact2" with a stable
sort) the per-tile ORDER too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_cameras, make_states, n, t

torch.set_num_threads(1)


def _project_both(rng, b=2, h=40, w=56, scale_boost=0.0):
    from gaussianip_tpu.render.preprocess import project_gaussians as jproj
    from gaussianip_tpu_torch.render.preprocess import project_gaussians

    js, ts = make_states(rng)
    if scale_boost:
        js = js.replace(scaling=js.scaling + scale_boost)
        ts = ts.replace(scaling=ts.scaling + scale_boost)
    jc, tc = make_cameras(b, h, w)
    ref = jax.vmap(lambda cam: jproj(
        js.xyz, js.get_scaling(), js.rotation, js.get_opacity()[:, 0],
        js.get_features(), cam, 0, 1.0, None, None, js.active_mask()))(jc)
    got = project_gaussians(
        ts.xyz, ts.get_scaling(), ts.rotation, ts.get_opacity()[:, 0],
        ts.get_features(), tc, 0, 1.0, None, None, ts.active_mask())
    return ref, got


def test_project_gaussians(rng):
    ref, got = _project_both(rng)
    for f in ("radius", "valid", "radius_bin", "radius_cull"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    valid = np.asarray(ref.valid)
    for f in ("mean2d", "conic", "color", "depth"):
        np.testing.assert_allclose(n(getattr(got, f))[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(n(got.opacity), np.asarray(ref.opacity)[0],
                               rtol=1e-6)


def test_gaussian_power_coeffs(rng):
    from gaussianip_tpu.render.preprocess import gaussian_power_coeffs as jc
    from gaussianip_tpu_torch.render.preprocess import gaussian_power_coeffs

    m = rng.uniform(-8, 24, (64, 2)).astype(np.float32)
    con = np.abs(rng.normal(0, 0.2, (64, 3))).astype(np.float32)
    op = rng.uniform(0, 1, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        n(gaussian_power_coeffs(t(m), t(con), t(op))),
        np.asarray(jc(jnp.asarray(m), jnp.asarray(con), jnp.asarray(op))),
        rtol=1e-5, atol=1e-5)


def _segments(gidx, starts, counts):
    """[B][NT] per-tile instance lists."""
    return [[list(gidx[c, s:s + k]) for s, k in zip(starts[c], counts[c])]
            for c in range(len(starts))]


@pytest.mark.parametrize("depth_key,pool", [
    ("q16", 0), ("rank", 0), ("exact2", 0),
    ("exact2", 256),  # a pool far too small: overflow must be counted alike
])
def test_bin_instances(rng, depth_key, pool):
    from gaussianip_tpu.render.binning import bin_instances as jbin
    from gaussianip_tpu.render.render import _auto_pool
    from gaussianip_tpu_torch.render.binning import bin_instances

    h, w, tile, d_max = 40, 56, 16, 16
    ref_p, _ = _project_both(rng, h=h, w=w, scale_boost=0.8)
    ntx, nty = -(-w // tile), -(-h // tile)
    nn_ = ref_p.depth.shape[1]
    pool = pool or _auto_pool(nn_, 128, h, w, 1, tile, d_max)
    kw = dict(tile=tile, n_tiles_x=ntx, n_tiles_y=nty, d_max=d_max,
              pool=pool)
    refs = [jbin(ref_p.mean2d[i], ref_p.radius_bin[i], ref_p.depth[i],
                 ref_p.valid[i], ref_p.radius_cull[i], chunk=128,
                 depth_key=depth_key, sort_stable=True, table_gather="i32",
                 **kw) for i in range(2)]
    got = bin_instances(t(ref_p.mean2d), t(ref_p.radius_bin),
                        t(ref_p.depth), t(ref_p.valid), t(ref_p.radius_cull),
                        depth_key=depth_key, sort_stable=True, **kw)
    ref_n_dropped = [int(r.n_dropped) for r in refs]
    assert list(n(got.n_dropped)) == ref_n_dropped
    if pool == 256:
        assert min(ref_n_dropped) > 0
    for c, r in enumerate(refs):
        np.testing.assert_array_equal(n(got.counts[c]), np.asarray(r.counts))
    seg_got = _segments(n(got.gidx), n(got.starts), n(got.counts))
    seg_ref = _segments(np.stack([np.asarray(r.gidx) for r in refs]),
                        np.stack([np.asarray(r.starts) for r in refs]),
                        np.stack([np.asarray(r.counts) for r in refs]))
    for c in range(2):
        for a, b_ in zip(seg_got[c], seg_ref[c]):
            if depth_key == "exact2":
                assert a == b_
            else:
                assert sorted(a) == sorted(b_)
    # dead slots: gidx == N and tile_of == NT exactly where the JAX side has
    live_ref = np.stack([np.asarray(r.gidx) for r in refs]) < nn_
    np.testing.assert_array_equal(n(got.gidx) < nn_, live_ref)
    np.testing.assert_array_equal(
        n(got.tile_of)[live_ref],
        np.stack([np.asarray(r.tile_of) for r in refs])[live_ref])
