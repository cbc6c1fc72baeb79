"""The port's `render` (forward and autograd gradients, including the
mean2d_offset viewspace gradient) against the JAX package's render with the
Pallas compositor in interpret mode and with the dense reference.

Tolerances as tests/test_render_pallas.py:159-221: images q99 |diff| < 3e-4
(depth 2e-3) with a worst case < 100x, gradients allclose(atol=5e-3,
rtol=2e-2). The JAX side pins the exact order and full precision
(depth_key="exact2", sort_stable=True, tri="highest", table_gather="i32").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS, make_cameras, make_states, n, t

torch.set_num_threads(1)

GRAD_FIELDS = ("xyz", "f_dc", "scaling", "rotation", "opacity")


def _cfgs(backend):
    from gaussianip_tpu.render.render import RenderConfig as JCfg
    from gaussianip_tpu_torch.render.render import RenderConfig

    if backend == "reference":
        return JCfg(backend="reference"), RenderConfig(backend="reference")
    return (JCfg(backend="pallas", interpret=True, tile=16, chunk=128,
                 d_max=16, depth_key="exact2", sort_stable=True,
                 tri="highest", table_gather="i32"),
            RenderConfig(d_max=16, depth_key="exact2", sort_stable=True))


def close(a, b, atol, name):
    d = np.abs(n(a) - np.asarray(b))
    assert np.quantile(d, 0.99) < atol, f"{name}: q99 {np.quantile(d, 0.99)}"
    assert d.max() < 100 * atol, f"{name}: max {d.max()}"


@pytest.mark.parametrize("backend", ["tiles", "reference"])
def test_render_forward(rng, backend):
    from gaussianip_tpu.render.render import render as jrender
    from gaussianip_tpu_torch.render.render import render

    js, ts = make_states(rng)
    jc, tc = make_cameras(2, 40, 56)
    jcfg, cfg = _cfgs(backend)
    bg = np.array([0.0, 0.1, 0.2], np.float32)
    ref = jrender(js, jc, jnp.asarray(bg), jcfg)
    got = render(ts, tc, t(bg), cfg)
    close(got.rgb, ref.rgb, 3e-4, "rgb")
    close(got.alpha, ref.alpha, 3e-4, "alpha")
    close(got.depth, ref.depth, 2e-3, "depth")
    np.testing.assert_array_equal(n(got.radii), np.asarray(ref.radii))
    np.testing.assert_array_equal(n(got.n_dropped), np.asarray(ref.n_dropped))


@pytest.mark.parametrize("backend", ["tiles", "reference"])
def test_render_gradients(rng, backend):
    from gaussianip_tpu.render.render import render as jrender
    from gaussianip_tpu_torch.render.render import render

    h = w = 32
    js, ts = make_states(rng, n_pts=200, capacity=256)
    jc, tc = make_cameras(1, h, w)
    tgt = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    jcfg, cfg = _cfgs(backend)
    bg = np.ones(3, np.float32)

    def jloss(state, offset):
        out = jrender(state, jc, jnp.asarray(bg), jcfg, mean2d_offset=offset)
        return jnp.sum((out.rgb - tgt) ** 2) + 0.1 * jnp.sum(out.depth)

    jg, joff = jax.grad(jloss, argnums=(0, 1), allow_int=True)(
        js, jnp.zeros((1, 256, 2)))

    leaves = {f: getattr(ts, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    offset = torch.zeros((1, 256, 2), requires_grad=True)
    out = render(ts.replace(**leaves), tc, t(bg), cfg, mean2d_offset=offset)
    loss = ((out.rgb - t(tgt)) ** 2).sum() + 0.1 * out.depth.sum()
    loss.backward()
    for f in GRAD_FIELDS:
        np.testing.assert_allclose(n(leaves[f].grad), np.asarray(getattr(jg, f)),
                                   atol=5e-3, rtol=2e-2, err_msg=f)
    np.testing.assert_allclose(n(offset.grad), np.asarray(joff), atol=5e-3,
                               rtol=2e-2, err_msg="viewspace (mean2d offset)")


def test_count_live_instances(rng):
    from gaussianip_tpu.render.render import count_live_instances as jcount
    from gaussianip_tpu_torch.render.render import count_live_instances

    js, ts = make_states(rng)
    js = js.replace(scaling=js.scaling + 1.2)
    ts = ts.replace(scaling=ts.scaling + 1.2)
    jc, tc = make_cameras(2, 64, 64)
    jcfg, cfg = _cfgs("tiles")
    np.testing.assert_array_equal(n(count_live_instances(ts, tc, cfg)),
                                  np.asarray(jcount(js, jc, jcfg)))


def test_render_deformed(rng):
    from gaussianip_tpu.render.render import render_deformed as jdeformed
    from gaussianip_tpu_torch.render.render import render_deformed

    js, ts = make_states(rng)
    jc, tc = make_cameras(1, 32, 32)
    xyz = rng.normal(0, 0.3, (300, 3)).astype(np.float32)
    rot = rng.normal(0, 1, (300, 4)).astype(np.float32)
    jcfg, cfg = _cfgs("reference")
    bg = np.zeros(3, np.float32)
    ref = jdeformed(js, jnp.asarray(xyz), jnp.asarray(rot), jc,
                    jnp.asarray(bg), jcfg)
    got = render_deformed(ts, t(xyz), t(rot), tc, t(bg), cfg)
    close(got.rgb, ref.rgb, 3e-4, "rgb")
    np.testing.assert_array_equal(n(got.radii), np.asarray(ref.radii))
