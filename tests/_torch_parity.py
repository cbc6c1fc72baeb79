"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
numpy <-> torch conversion and one scene built identically in both
packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    a = np.array(x)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def n(x):
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_state_numpy(js) -> dict:
    """A JAX GaussianState as the numpy dict `state_from_numpy` takes."""
    d = {f: np.asarray(getattr(js, f)) for f in PARAM_FIELDS}
    d.update(n_active=int(js.n_active), max_sh_degree=js.max_sh_degree,
             active_sh_degree=js.active_sh_degree)
    return d


def make_states(rng, n_pts=400, capacity=512, opacity=(-2.0, 3.0)):
    """The same random splat scene as a JAX and a torch (CPU) GaussianState:
    points N(0, 0.3), random colours, opacity logits uniform in `opacity`."""
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.knn import mean_dist2_3nn
    from gaussianip_tpu_torch.model.gaussians import state_from_numpy

    pts = rng.normal(0, 0.3, (n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    d2 = mean_dist2_3nn(jnp.asarray(pts), block=256)
    js = create_from_pcd(pts, cols, capacity, d2)
    op = rng.uniform(*opacity, (capacity, 1)).astype(np.float32)
    js = js.replace(opacity=jnp.asarray(op))
    return js, state_from_numpy(jax_state_numpy(js), "cpu")


def make_cameras(b, h, w, dist=2.0):
    """An orbit of b cameras as (JAX Camera batch, torch Camera)."""
    from gaussianip_tpu.data.cameras import camera_from_c2w as jcam
    from gaussianip_tpu.ops.camera_math import look_at_c2w
    from gaussianip_tpu_torch.data.cameras import camera_from_c2w

    az = jnp.linspace(0, 2 * jnp.pi, b, endpoint=False)
    eye = jnp.stack([dist * jnp.cos(az), dist * jnp.sin(az),
                     0.3 * jnp.ones(b)], -1)
    c2w = look_at_c2w(eye, jnp.zeros((b, 3)),
                      jnp.tile(jnp.array([[0.0, 0, 1]]), (b, 1)))
    fovy = jnp.full((b,), 0.9, jnp.float32)
    jc = jax.vmap(lambda m, f: jcam(m, f, h, w))(c2w, fovy)
    return jc, camera_from_c2w(t(c2w), t(fovy), h, w)
