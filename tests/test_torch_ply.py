"""The port's .ply I/O (gaussianip_tpu_torch/model/ply.py) against the JAX
package's writer and reader on the same state: the files' bytes are
equal, each package reads the other's file to the same arrays, and the
round trip through the port's writer and reader is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS, jax_state_numpy, n

torch.set_num_threads(1)


def _jax_state(rng, n_pts, cap, deg):
    from gaussianip_tpu.model.gaussians import create_from_pcd

    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    st = create_from_pcd(pts, cols, cap, rng.uniform(0.01, 0.1, n_pts),
                         max_sh_degree=deg)
    rand = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
    return st.replace(f_rest=rand(st.f_rest), rotation=rand(st.rotation),
                      opacity=rand(st.opacity))


@pytest.mark.parametrize("deg", [0, 3])
def test_ply_bytes_equal_jax_writer(tmp_path, rng, deg):
    from gaussianip_tpu.model import ply as jply
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy
    from gaussianip_tpu_torch.model.ply import state_to_ply

    js = _jax_state(rng, 37, 64, deg)
    jply.state_to_ply(js, str(tmp_path / "jax.ply"))
    state_to_ply(state_from_numpy(jax_state_numpy(js), "cpu"),
                 str(tmp_path / "port.ply"))
    a = (tmp_path / "jax.ply").read_bytes()
    b = (tmp_path / "port.ply").read_bytes()
    assert a == b


@pytest.mark.parametrize("deg", [0, 3])
def test_ply_read_matches_jax_reader(tmp_path, rng, deg):
    """The port reads the JAX writer's file to the JAX reader's state, and
    its own round trip is exact."""
    from gaussianip_tpu.model import ply as jply
    from gaussianip_tpu_torch.model.ply import state_from_ply, state_to_ply

    js = _jax_state(rng, 50, 128, deg)
    path = str(tmp_path / "a.ply")
    jply.state_to_ply(js, path)
    ref = jply.state_from_ply(path)
    got = state_from_ply(path, device="cpu")
    assert got.capacity == ref.capacity == 4096
    assert got.n_active == int(ref.n_active) == 50
    assert got.max_sh_degree == ref.max_sh_degree == deg
    assert got.active_sh_degree == ref.active_sh_degree
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    state_to_ply(got, str(tmp_path / "b.ply"))
    again = state_from_ply(str(tmp_path / "b.ply"), capacity=64,
                           device="cpu")
    assert again.capacity == 64 and again.n_active == 50
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(getattr(again, f))[:50],
                                      n(getattr(got, f))[:50], f)


def test_state_from_ply_raises_sh_degree(tmp_path, rng):
    """A degree-0 file loaded at max_sh_degree 2 gets zero f_rest rows and
    the JAX reader's layout."""
    from gaussianip_tpu.model import ply as jply
    from gaussianip_tpu_torch.model.ply import state_from_ply

    js = _jax_state(rng, 9, 16, 0)
    path = str(tmp_path / "s.ply")
    jply.state_to_ply(js, path)
    ref = jply.state_from_ply(path, capacity=16, max_sh_degree=2)
    got = state_from_ply(path, capacity=16, max_sh_degree=2, device="cpu")
    assert got.f_rest.shape == (16, 8, 3) and got.max_sh_degree == 2
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    with pytest.raises(ValueError):
        state_from_ply(path, capacity=8, device="cpu")
