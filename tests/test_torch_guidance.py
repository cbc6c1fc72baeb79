"""The port's guidance against the JAX package on the CPU: the AHDS
schedule and timestep draw, the ANPG / SDS gradients and loss, the prompt
tables, ProjPlusModel, and AHDSGuidance.__call__ on the tiny random stack
of tests/test_guidance_ipa.py with the draws of the JAX key split.

Tolerances: float32 values within 1e-4 of their largest |value|,
gradients within 1e-3 (as tests/test_torch_diffusion.py); the schedule,
timesteps and direction indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_rel_close, jax_draws, n, nchw, nhwc,
                           random_flax_params, t, tiny_guidance_pair)

torch.set_num_threads(1)
OUT_TOL = 1e-4
GRAD_TOL = 1e-3


def test_ahds_schedule_bit_exact():
    from gaussianip_tpu.guidance.ahds import make_ahds_schedule as jmake
    from gaussianip_tpu_torch.guidance.ahds import make_ahds_schedule

    js, s = jmake(), make_ahds_schedule()
    np.testing.assert_array_equal(s.chosen_t, np.asarray(js.chosen_t))
    assert s.chosen_t_min == int(js.chosen_t_min)


@pytest.mark.parametrize("step", [0, 699, 700, 899, 900, 1399, 1400, 2399])
def test_sample_timesteps_all_windows(step):
    """u from the same jax.random.randint call sample_timesteps makes."""
    from gaussianip_tpu.guidance.ahds import make_ahds_schedule as jmake
    from gaussianip_tpu.guidance.ahds import sample_timesteps as jsample
    from gaussianip_tpu_torch.guidance.ahds import (make_ahds_schedule,
                                                    sample_timesteps)

    key = jax.random.PRNGKey(step)
    u = jax.random.randint(key, (64,), 0, 1 << 30)
    ref = jsample(jmake(), key, jnp.int32(step), 64)
    got = sample_timesteps(make_ahds_schedule(), t(u), step)
    np.testing.assert_array_equal(n(got), np.asarray(ref))


def _preds(rng, b=4):
    return [rng.normal(0, 1, (b, 8, 8, 4)).astype(np.float32)
            for _ in range(3)]


def test_anpg_sds_grad_and_loss(rng):
    """Both sides of the t < 170 mask, and the per-pixel clip over
    channels (NHWC axis -1, NCHW dim 1)."""
    from gaussianip_tpu.diffusion.scheduler import make_ddim_schedule as jd
    from gaussianip_tpu.guidance import ahds as ja
    from gaussianip_tpu_torch.diffusion.scheduler import make_ddim_schedule
    from gaussianip_tpu_torch.guidance import ahds as pa

    jac = jd().alphas_cumprod
    ac = make_ddim_schedule(device="cpu").alphas_cumprod
    neg, pos, null = _preds(rng)
    tt = np.array([20, 169, 170, 700], np.int32)
    for clip in (True, False):
        ref = ja.anpg_grad(jnp.asarray(neg), jnp.asarray(pos),
                           jnp.asarray(null), jnp.asarray(tt), jac,
                           grad_clip_pixel=clip, grad_clip_threshold=0.5)
        got = pa.anpg_grad(nchw(neg), nchw(pos), nchw(null), t(tt).long(),
                           ac, grad_clip_pixel=clip, grad_clip_threshold=0.5)
        assert_rel_close(nhwc(got), ref, OUT_TOL, f"anpg clip={clip}")
    noise = rng.normal(0, 1, neg.shape).astype(np.float32)
    for resc in (0.0, 0.75):
        ref = ja.sds_grad(jnp.asarray(neg), jnp.asarray(pos),
                          jnp.asarray(noise), jnp.asarray(tt), jac,
                          guidance_rescale=resc)
        got = pa.sds_grad(nchw(neg), nchw(pos), nchw(noise), t(tt).long(),
                          ac, guidance_rescale=resc)
        assert_rel_close(nhwc(got), ref, OUT_TOL, f"sds rescale={resc}")
    lat = rng.normal(0, 1, neg.shape).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda x: ja.sds_loss(x, jnp.asarray(pos)))(
        jnp.asarray(lat))
    x = nchw(lat).requires_grad_(True)
    loss = pa.sds_loss(x, nchw(pos))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert_rel_close(nhwc(x.grad), jg, GRAD_TOL, "d sds_loss")


def _aux_numpy(b):
    return {
        "all_vis": np.array([0, 1, 0, 1, 0, 0][:b], np.float32),
        "elevation": np.zeros(b, np.float32),
        "azimuth": np.linspace(-170, 170, b).astype(np.float32),
        "center": np.array([0, 0, 0.65, 0, 0.65, 0][:b], np.float32),
        "camera_distances": np.full(b, 1.5, np.float32),
    }


def test_direction_index_and_text_embeddings():
    from gaussianip_tpu.guidance import prompts as jp
    from gaussianip_tpu_torch.guidance import prompts as pp

    aux = _aux_numpy(6)
    args = [aux[k] for k in ("elevation", "azimuth", "center", "all_vis",
                             "camera_distances")]
    ref = jp.direction_index(*map(jnp.asarray, args))
    np.testing.assert_array_equal(n(pp.direction_index(*map(t, args))),
                                  np.asarray(ref))
    jpe = jp.make_prompt_embeddings(jp.fake_text_encoder(77, 16), "a person",
                                    "bad", "")
    pe = pp.make_prompt_embeddings(pp.fake_text_encoder(77, 16), "a person",
                                   "bad", "", device="cpu")
    for vd in (True, False):
        ref = jpe.get_text_embeddings(*map(jnp.asarray, args),
                                      view_dependent=vd)
        got = pe.get_text_embeddings(*map(t, args), view_dependent=vd)
        np.testing.assert_array_equal(n(got), np.asarray(ref))


def test_prompt_cache_and_classic_table(tmp_path):
    """The disk cache gives the uncached table; the classic directions and
    the prompt-library lookup as the JAX package."""
    from gaussianip_tpu.guidance import prompts as jp
    from gaussianip_tpu_torch.guidance import prompts as pp

    enc = pp.fake_text_encoder(77, 8)
    a = pp.make_prompt_embeddings(enc, "p", "q", device="cpu")
    for _ in range(2):  # cold, then warm cache
        b = pp.make_prompt_embeddings(enc, "p", "q", cache_dir=str(tmp_path),
                                      model_name="m", device="cpu")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(n(x), n(y))
    azi = np.array([90.0, -90.0, 10.0, 30.0], np.float32)
    cz = np.array([0.0, 0.0, 0.0, 0.65], np.float32)
    args = (np.zeros(4, np.float32), azi, cz, np.full(4, 1.5, np.float32))
    np.testing.assert_array_equal(
        n(pp.classic_direction_index(*map(t, args))),
        np.asarray(jp.classic_direction_index(*map(jnp.asarray, args))))
    lib = tmp_path / "lib.json"
    lib.write_text('{"dreamfusion": ["a DSLR photo of a corgi", '
                   '"a photo of a cat"]}')
    assert pp.preprocess_prompt("lib:corgi", str(lib)) == \
        jp.preprocess_prompt("lib:corgi", str(lib))
    with pytest.raises(ValueError):
        pp.preprocess_prompt("lib:photo", str(lib))


def test_proj_plus_and_image_embeds(rng):
    from gaussianip_tpu.diffusion.ip_adapter import ProjPlusModel as JProj
    from gaussianip_tpu.guidance.ipa import compute_image_embeds as jcie
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.guidance.ipa import compute_image_embeds

    kw = dict(cross_attention_dim=64, id_embeddings_dim=32,
              clip_embeddings_dim=48, num_tokens=4)
    ide = rng.normal(size=(1, 32)).astype(np.float32)
    clip = rng.normal(size=(1, 9, 48)).astype(np.float32)
    jm = JProj(**kw)
    p = random_flax_params(jm, rng, ide, clip)
    m = from_flax(ProjPlusModel(**kw), p)
    for shortcut in (False, True):
        ref = jm.apply(p, jnp.asarray(ide), jnp.asarray(clip),
                       shortcut=shortcut, scale=0.4)
        with torch.no_grad():
            got = m(t(ide), t(clip), shortcut=shortcut, scale=0.4)
        assert_rel_close(got, ref, OUT_TOL, f"shortcut={shortcut}")
    args = (ide, ide * 0.5, clip, clip * 0.5, np.zeros_like(clip))
    ref = jcie(jm, p, *map(jnp.asarray, args), s_scale=0.4)
    got = compute_image_embeds(m, *map(t, args), s_scale=0.4)
    for g, r, what in zip(got, ref, ("pos", "null", "neg")):
        assert_rel_close(g, r, OUT_TOL, what)


def test_resampler_plus(rng):
    from gaussianip_tpu.diffusion.ip_adapter import Resampler as JRes
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.ip_adapter import (
        Resampler, ipa_plus_image_embeds)

    kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=16,
              embedding_dim=24, output_dim=32)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    jm = JRes(**kw)
    p = random_flax_params(jm, rng, x)
    m = from_flax(Resampler(**kw), p)
    with torch.no_grad():
        pos, neg = ipa_plus_image_embeds(m, t(x), torch.zeros(2, 9, 24))
    assert_rel_close(pos, jm.apply(p, jnp.asarray(x)), OUT_TOL, "pos")
    assert_rel_close(neg, jm.apply(p, jnp.zeros((2, 9, 24))), OUT_TOL, "neg")


@pytest.fixture(scope="module")
def tiny_pair():
    return tiny_guidance_pair(np.random.default_rng(21))


def test_ahds_guidance_call_matches_jax(tiny_pair):
    """loss_sds, grad_norm, t_mean and d loss_sds / d rgb at two steps
    (two timestep windows, both sides of the t < 170 mask at step 2000),
    with the render at 48^2 so both resizes run upward."""
    jg, g = tiny_pair
    rng = np.random.default_rng(3)
    b = 3
    rgb = rng.uniform(0, 1, (b, 48, 48, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 1, (b, 48, 48, 3)).astype(np.float32)
    aux = _aux_numpy(b)
    for step in (100, 2000):
        key = jax.random.PRNGKey(step)

        def jloss(r):
            out = jg(jnp.int32(step), key, r, jnp.asarray(ctrl),
                     {k: jnp.asarray(v) for k, v in aux.items()})
            return out["loss_sds"], out

        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(rgb))
        x = t(rgb).requires_grad_(True)
        out = g(step, jax_draws(key, b), x, t(ctrl),
                {k: t(v) for k, v in aux.items()})
        out["loss_sds"].backward()
        for k in ("loss_sds", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                       rtol=OUT_TOL, err_msg=k)
        assert float(jnp.abs(jgrad).max()) > 0
        assert_rel_close(x.grad, jgrad, GRAD_TOL, f"d loss / d rgb {step}")


def test_sample_noise_shapes_and_order():
    """u, then noise, then eps from one generator; latent-shaped from
    image_size and the VAE's depth."""
    from gaussianip_tpu_torch.system.pipeline import build_stub_guidance_stack

    g = build_stub_guidance_stack("a person", "bad", 64, device="cpu")
    d = g.sample_noise(torch.Generator().manual_seed(0), (2, 48, 48, 3),
                       "cpu")
    gen = torch.Generator().manual_seed(0)
    u = torch.randint(0, 1 << 30, (2,), generator=gen)
    noise = torch.randn((2, 4, 32, 32), generator=gen)
    assert torch.equal(d["u"], u) and torch.equal(d["noise"], noise)
    assert d["eps"].shape == (2, 4, 32, 32)
