"""State carry-over into the port: state_from_numpy / train_state_from_numpy
round trips, from JAX objects and back out of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS, jax_state_numpy, make_states, n

torch.set_num_threads(1)


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_state_from_numpy_round_trip(rng, sh_degree):
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.model.gaussians import (state_from_numpy,
                                                      state_to_numpy)

    pts = rng.normal(0, 0.3, (50, 3)).astype(np.float32)
    js = create_from_pcd(pts, rng.uniform(0, 1, (50, 3)), 64,
                         jnp.full((50,), 0.01), max_sh_degree=sh_degree)
    js = js.replace(f_rest=jnp.asarray(
        rng.normal(0, 1, js.f_rest.shape).astype(np.float32)))
    d = jax_state_numpy(js)
    g = state_from_numpy(d, "cpu")
    assert g.capacity == 64 and g.n_active == 50
    assert g.max_sh_degree == sh_degree
    back = state_to_numpy(g)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(back[f], d[f])
        assert getattr(g, f).dtype == torch.float32
    # the port owns its memory: writing to it leaves the source untouched
    g.xyz += 1.0
    np.testing.assert_array_equal(d["xyz"], np.asarray(js.xyz))


def test_create_from_pcd_matches(rng):
    from gaussianip_tpu.model.gaussians import create_from_pcd as jcreate
    from gaussianip_tpu_torch.model.gaussians import create_from_pcd

    pts = rng.normal(0, 0.3, (50, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    d2 = rng.uniform(0, 0.01, (50,)).astype(np.float32)
    js = jcreate(pts, cols, 64, jnp.asarray(d2))
    g = create_from_pcd(pts, cols, 64, d2, device="cpu")
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(n(getattr(g, f)),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(n(g.active_mask()),
                                  np.asarray(js.active_mask()))


def test_train_state_from_numpy(rng):
    from gaussianip_tpu.system.stage1 import init_train_state
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy

    js, _ = make_states(rng, n_pts=40, capacity=64)
    jts = init_train_state(js)
    m = {f: rng.normal(0, 1, a.shape).astype(np.float32)
         for f, a in jts.opt.m.items()}
    v = {f: rng.uniform(0, 1, a.shape).astype(np.float32)
         for f, a in jts.opt.v.items()}
    stats = {f: rng.uniform(0, 1, (64,)).astype(np.float32)
             for f in ("xyz_grad_accum", "denom", "max_radii2d")}
    d = {"gaussians": jax_state_numpy(js), "m": m, "v": v, "adam_count": 7,
         "stats": stats, "step": 12}
    ts = train_state_from_numpy(d, "cpu")
    assert ts.step == 12 and ts.opt.count == 7
    assert ts.gaussians.n_active == 40
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(ts.opt.m[f]), m[f])
        np.testing.assert_array_equal(n(ts.opt.v[f]), v[f])
    for f, a in stats.items():
        np.testing.assert_array_equal(n(getattr(ts.stats, f)), a)
