"""The port's stage-1 step with the AHDS / ANPG guidance against the JAX
package's, on the tiny random guidance stack (tests/_torch_parity.py:
tiny_guidance_pair) at 64^2 renders: the same state, the camera batches of
the JAX step's own key split and the guidance draws of the guidance's own
split (system/stage1.py: k_cam, k_guid = split(key); guidance/ipa.py:
k_t, k_noise, k_vae = split(k_guid, 3)).

Tolerances as tests/test_torch_stage1.py: the loss to 1e-4 relative; Adam
m and the densify stats to 1e-2 of the field's largest |value|, v to
2e-2; parameters: the 99th percentile of |diff| within 2e-2 of the
field's learning rate and every entry within Adam's bound of 2 lr per step
(rotation, whose gradient is rounding noise on isotropic gaussians, to the
bound only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PARAM_FIELDS, jax_draws, n, stage1_scene, t,
                           tiny_guidance_pair, train_state_numpy)

torch.set_num_threads(1)
H = W = 64
B = 2
MOM_TOL = {"m": 1e-2, "v": 2e-2}


@pytest.fixture(scope="module")
def scene():
    return stage1_scene()


def test_guided_steps_match(scene):
    from gaussianip_tpu.data.sampler import CameraSamplerConfig as JCam
    from gaussianip_tpu.data.sampler import sample_train_batch as jsample
    from gaussianip_tpu.model.adam import AdamHyper as JAdam
    from gaussianip_tpu.model.adam import field_lrs
    from gaussianip_tpu.render.render import RenderConfig as JRender
    from gaussianip_tpu.system.stage1 import Stage1Config as JS1
    from gaussianip_tpu.system.stage1 import make_train_step as jmake
    from gaussianip_tpu_torch.data.sampler import (CameraBatch,
                                                   CameraSamplerConfig)
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system.stage1 import (Stage1Config,
                                                    make_inner_step,
                                                    train_state_from_numpy)

    sk, jts = scene
    jts = jax.tree_util.tree_map(jnp.array, jts)  # the JAX step donates it
    jg, g = tiny_guidance_pair(np.random.default_rng(31), image_size=H)
    s1 = dict(render_height=H, render_width=W)
    cam = dict(height=H, width=W, batch_size=B, head_start_step=0,
               back_start_step=0)
    jcam = JCam(**cam)
    jstep = jmake(JS1(**s1), jcam,
                  JRender(backend="pallas", interpret=True, d_max=16,
                          depth_key="exact2", sort_stable=True, tri="highest",
                          table_gather="i32"), JAdam(), jg, sk.points3d)
    inner = make_inner_step(
        Stage1Config(**s1), CameraSamplerConfig(**cam),
        RenderConfig(d_max=16, depth_key="exact2", sort_stable=True),
        AdamHyper(), g, sk.points3d)
    ts = train_state_from_numpy(train_state_numpy(jts), "cpu")
    lrs = field_lrs(JAdam(), 0)
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        k_cam, k_guid = jax.random.split(key)
        jb = jsample(jcam, k_cam, jts.step)
        jts, jm = jstep(jts, key)
        ts, m = inner(ts, CameraBatch(*(t(x) for x in jb)),
                      jax_draws(k_guid, B, H // 2))
        for k in ("loss", "loss_sds"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert float(jm["loss_sds"]) > 0
        assert ts.step == int(jts.step)
        for f in PARAM_FIELDS:
            a = n(getattr(ts.gaussians, f))
            b = np.asarray(getattr(jts.gaussians, f))
            if a.size == 0:
                continue
            d = np.abs(a - b)
            lr = float(lrs[f])
            if f != "rotation":
                assert np.quantile(d / lr, 0.99) <= 2e-2, f
            assert d.max() <= 2 * lr * (i + 1) + 1e-7, f
            for mom in ("m", "v") if f != "rotation" else ():
                a = n(getattr(ts.opt, mom)[f])
                b = np.asarray(getattr(jts.opt, mom)[f])
                tol = MOM_TOL[mom] * max(np.abs(b).max(), 1e-30)
                assert np.abs(a - b).max() <= tol, (f, mom)
        for f in ("xyz_grad_accum", "denom", "max_radii2d"):
            a, b = n(getattr(ts.stats, f)), np.asarray(getattr(jts.stats, f))
            assert np.abs(a - b).max() <= 1e-2 * max(np.abs(b).max(), 1e-30), f
