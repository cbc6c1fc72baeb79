"""The port's side modules against the JAX package on the CPU: Adan
(model/adan.py) against the optax transform, the patch sampler
(data/patch_sampler.py) and the live viewer (utils/viewer.py).

The patch sampler's weighted draw (jax.random.choice) has no equal in
torch: the crop is held to the JAX package's on the JAX package's own
corners, and the port's draws are checked for where they land. The viewer
is served on port 0 and its PNG held to the port's own render of the same
camera, pixel for pixel, and to the JAX viewer's image."""

import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t

torch.set_num_threads(1)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adan_matches_optax(rng, weight_decay):
    """5 steps on two parameter tensors with random gradients, within 1e-5
    (the JAX side applies p + (p' - p), the port p' itself)."""
    import optax

    from gaussianip_tpu.model.adan import adan
    from gaussianip_tpu_torch.model.adan import Adan

    shapes = {"a": (7, 3), "b": (11,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = adan(learning_rate=0.05, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: t(v).requires_grad_(True) for k, v in params.items()}
    opt = Adan(list(tp.values()), lr=0.05, weight_decay=weight_decay)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    st = opt.state[tp["a"]]
    assert st["step"] == 5
    np.testing.assert_allclose(n(st["n"]), np.asarray(js.n["a"]), rtol=1e-5,
                               atol=1e-7)


def test_adan_first_step_has_no_diff():
    """On the first step diff = 0: v stays 0 and n = b3 g^2."""
    from gaussianip_tpu_torch.model.adan import Adan

    p = torch.zeros(4, requires_grad=True)
    opt = Adan([p], lr=0.1)
    p.grad = torch.tensor([1.0, -2.0, 3.0, 0.5])
    opt.step()
    st = opt.state[p]
    assert torch.equal(st["v"], torch.zeros(4))
    torch.testing.assert_close(st["n"], 0.01 * p.grad ** 2)


def _image_and_mask(rng, h=40, w=48):
    image = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[14:26, 18:30] = 1.0
    return image, mask


@pytest.mark.parametrize("foreground", [True, False])
def test_patch_crop_on_jax_corners(rng, foreground):
    """crop_patches on the JAX package's corners gives its patches exactly,
    with and without foreground."""
    import jax

    from gaussianip_tpu.data.patch_sampler import sample_patches as jsample
    from gaussianip_tpu_torch.data.patch_sampler import crop_patches

    image, mask = _image_and_mask(rng)
    if not foreground:
        mask[:] = 0.0
    jp, jc = jsample(jax.random.PRNGKey(3), jnp.asarray(image),
                     jnp.asarray(mask), 8, 16)
    got = crop_patches(t(image), t(np.asarray(jc), np.int64), 8)
    np.testing.assert_array_equal(n(got), np.asarray(jp))


def test_patch_draws_land_on_foreground(rng):
    """The port's centres (corner + half) lie on mask > 0.5 pixels; with no
    foreground every corner keeps the patch inside the image."""
    from gaussianip_tpu_torch.data.patch_sampler import sample_patches

    image, mask = _image_and_mask(rng)
    gen = torch.Generator().manual_seed(0)
    patches, corners = sample_patches(gen, t(image), t(mask), 8, 64)
    assert patches.shape == (64, 8, 8, 3)
    c = n(corners)
    assert mask[c[:, 0] + 4, c[:, 1] + 4].min() > 0.5
    np.testing.assert_array_equal(n(patches[0]),
                                  image[c[0, 0]:c[0, 0] + 8,
                                        c[0, 1]:c[0, 1] + 8])
    _, corners = sample_patches(gen, t(image), t(np.zeros_like(mask)), 8, 64)
    c = n(corners)
    assert c.min() >= 0 and c[:, 0].max() <= 32 and c[:, 1].max() <= 40
    assert len(np.unique(c, axis=0)) > 1


def test_viewer_serves_render(rng):
    """GET / and /render on port 0; the PNG equals the port's render of the
    orbit camera as uint8 and the JAX viewer's image within one level on
    all but the gate pixels."""
    from _torch_parity import make_states
    from gaussianip_tpu.utils.viewer import ViewerState as JViewerState
    from gaussianip_tpu_torch.render.render import RenderConfig, render
    from gaussianip_tpu_torch.utils.saving import decode_png
    from gaussianip_tpu_torch.utils.viewer import (ViewerState, orbit_camera,
                                                   start_viewer)

    js, gs = make_states(rng, n_pts=200, capacity=256)
    state = ViewerState()
    assert state.render(10, 5, 2.0, 16).max() == 0  # before the first update
    state.update(gs)
    server = start_viewer(state, port=0)
    try:
        port = server.server_address[1]
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                      timeout=30).read()
        assert b"gaussianip-tpu viewer" in page
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?size=32&radius=2.0&azimuth=30"
            f"&elevation=10", timeout=120).read()
    finally:
        server.shutdown()
        server.server_close()
    img = decode_png(png)
    want = render(gs, orbit_camera(30, 10, 2.0, 32, "cpu"), torch.zeros(3),
                  RenderConfig()).rgb[0]
    np.testing.assert_array_equal(img, n((want.clamp(0, 1) * 255)
                                         .to(torch.uint8)))
    jv = JViewerState()
    jv.update(js)
    ref = jv.render(30, 10, 2.0, 32).astype(np.int32)
    d = np.abs(img.astype(np.int32) - ref)
    assert img.max() > 0 and np.quantile(d, 0.99) <= 1, d.max()
