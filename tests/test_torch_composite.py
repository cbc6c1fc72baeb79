"""The port's compositor (its plain version, which the autograd Function
runs for CPU tensors) against the JAX Pallas compositor run with
interpret=True on the same data / starts / counts.

Tolerances as tests/test_render_pallas.py: forward rgb and alpha q99 |diff|
< 3e-4, depth < 2e-3, worst case < 100x (isolated pixels may flip across
the 1/255 and T=1e-4 gates: the Pallas kernel builds T in log space through
matmuls, the port with a cumprod); dgrad against JAX's VJP with atol 5e-3,
rtol 2e-2 plus 1e-3 of the row's largest |value|: the coefficient rows of
x^2, xy and y^2 sum 256 pixel terms weighted up to 225, so f32 rounding is
relative to the row, not to the entry (on these scenes both the Pallas VJP
and the port's f32 backward sit up to 4e-4 of the row max away from the
port's backward in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_cameras, make_states, n, t

torch.set_num_threads(1)
CHUNK = 128


def _inputs(rng, opacity, scale_boost):
    from gaussianip_tpu_torch.render.render import RenderConfig, instance_data

    _, ts = make_states(rng, opacity=opacity)
    ts = ts.replace(scaling=ts.scaling + scale_boost)
    _, cams = make_cameras(2, 40, 56)
    with torch.no_grad():
        data, bn = instance_data(ts, cams, RenderConfig(d_max=16))
    return data, bn.starts, bn.counts


def _jax_data(data):
    e = data.shape[2]
    epad = (-(-(e + CHUNK) // CHUNK)) * CHUNK + 4 * CHUNK
    return jnp.pad(jnp.asarray(n(data)), ((0, 0), (0, 0), (0, epad - e)))


def close(a, b, atol, name):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.quantile(d, 0.99) < atol, f"{name}: q99 {np.quantile(d, 0.99)}"
    assert d.max() < 100 * atol, f"{name}: max {d.max()}"


@pytest.mark.parametrize("opacity,scale_boost", [
    ((-2.0, 3.0), 0.0),
    ((1.0, 5.0), 0.6),  # opaque, wide: early stops and long segments
])
def test_composite_matches_pallas(rng, opacity, scale_boost):
    from gaussianip_tpu.render.composite_pallas import composite_tiles as jct
    from gaussianip_tpu_torch.render.composite_cuda import composite_tiles

    data, starts, counts = _inputs(rng, opacity, scale_boost)
    assert int(counts.max()) > CHUNK or scale_boost == 0.0
    jdata = _jax_data(data)
    js, jc = jnp.asarray(n(starts)), jnp.asarray(n(counts))
    f = lambda d: jct(d, js, jc, 16, CHUNK, True, "highest")
    ref, vjp = jax.vjp(f, jdata)

    x = data.clone().requires_grad_(True)
    out = composite_tiles(x, starts, counts, 16)
    close(n(out[:, :, 0:3]), ref[:, :, 0:3], 3e-4, "rgb")
    close(n(out[:, :, 4]), ref[:, :, 4], 3e-4, "alpha")
    close(n(out[:, :, 3]), ref[:, :, 3], 2e-3, "depth")

    gout = rng.normal(0, 1, out.shape).astype(np.float32)
    gout[:, :, 5:] = 0.0  # the render path feeds zeros to rows 5-7
    out.backward(t(gout))
    (jd,) = vjp(jnp.asarray(gout))
    e = data.shape[2]
    ref_d = np.asarray(jd)[:, :, :e]
    row_max = np.abs(ref_d).max(axis=(0, 2), keepdims=True)
    excess = np.abs(n(x.grad) - ref_d) - (5e-3 + 2e-2 * np.abs(ref_d)
                                          + 1e-3 * row_max)
    assert excess.max() <= 0, np.unravel_index(excess.argmax(), excess.shape)
    assert not np.asarray(jd)[:, :, e:].any()


def test_plain_versions_shapes_and_dead_rows(rng):
    """Output rows 6-7 and dgrad rows 6-7 / 13-15 are zero, row 5 holds
    segment-relative last-contributor indices inside the segment."""
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_plain, composite_fwd_plain)

    data, starts, counts = _inputs(rng, (-2.0, 3.0), 0.0)
    out = composite_fwd_plain(data, starts, counts)
    assert out.shape == (2, starts.shape[1], 8, 256)
    assert not out[:, :, 6:].any()
    last = out[:, :, 5]
    assert (last >= -1).all()
    assert (last < counts[..., None].to(last.dtype)).all()
    gout = torch.ones_like(out)
    dg = composite_bwd_plain(data, starts, counts, out, gout)
    assert dg.shape == data.shape
    assert not dg[:, 6:8].any() and not dg[:, 13:].any()


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_cuda, composite_fwd_cuda)

    data, starts, counts = _inputs(rng, (-2.0, 3.0), 0.0)
    with pytest.raises(ValueError):
        composite_fwd_cuda(data, starts, counts)
    out = torch.zeros(2, starts.shape[1], 8, 256)
    with pytest.raises(ValueError):
        composite_bwd_cuda(data, starts, counts, out, out)
