"""The port's real-weights loaders (gaussianip_tpu_torch/system/
pipeline.py) against the JAX package's (gaussianip_tpu/system/
pipeline.py) on the same released-layout files, and the command line's
real-weights branch end to end.

The files are a tiny released-layout set written from seeded random port
modules (system/standin.py): the UNet with a rank-4 IP-Adapter LoRA in
float16 .safetensors, the IP-Adapter .bin (float16), the VAE (float32),
the ControlNet (float16, the OpenPose embedder's 16/32/96/256), CLIP text
and ViT checkpoints, VGG16 + LPIPS heads, two face PNGs. Both packages
load them at tiny widths: each module's config builders
(`sd15_unet_config`, which also sizes the ControlNet, and `VAEConfig`;
the port's ProjPlusModel) are monkeypatched here, keeping the SD1.5
structure of 4 levels of 2 layers; nothing in either package changes.

Tolerances: the loaded modules bit-equal (from_flax of the JAX tree); one
guided step's loss within 1e-4 relative and its gradient with respect to
the rendered images within 1e-3 of the largest |gradient| (the loss's
tolerance is tests/test_torch_stage1_guided.py's); the face-identity
fallback's embedding and crop exact within one process; LPIPS within
1e-4 relative.
"""

import functools
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_draws, n, t
from test_lpips_wiring import lpips_ckpts  # noqa: F401  (the fixture)

torch.set_num_threads(1)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "exp.yaml")
UNET = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=2,
            cross_attention_dim=64, attention_head_dim=4, norm_groups=8)
VAE = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=2,
           norm_groups=4)
PROJ = dict(cross_attention_dim=64, clip_embeddings_dim=32)
IMAGE = 64
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
LPIPS_RTOL = 1e-4


def _patch(mp):
    """Both packages' config builders at the tiny widths."""
    from gaussianip_tpu.diffusion.unet import UNetConfig as JUNetConfig
    from gaussianip_tpu.diffusion.vae import VAEConfig as JVAEConfig
    from gaussianip_tpu.system import pipeline as jpl
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.diffusion.unet import UNetConfig
    from gaussianip_tpu_torch.diffusion.vae import VAEConfig
    from gaussianip_tpu_torch.system import pipeline as pl

    mp.setattr(jpl, "sd15_unet_config",
               lambda lora_rank=128, ip_tokens=4, dtype=jnp.bfloat16:
               JUNetConfig(lora_rank=lora_rank, ip_tokens=ip_tokens,
                           dtype=dtype, **UNET))
    mp.setattr(jpl, "VAEConfig", lambda dtype=jnp.float32:
               JVAEConfig(dtype=dtype, **VAE))
    mp.setattr(pl, "sd15_unet_config",
               lambda lora_rank=0, ip_tokens=4, dtype=torch.bfloat16:
               UNetConfig(lora_rank=lora_rank, ip_tokens=ip_tokens,
                          dtype=dtype, **UNET))
    mp.setattr(pl, "VAEConfig", lambda dtype=torch.float32:
               VAEConfig(dtype=dtype, **VAE))
    mp.setattr(pl, "ProjPlusModel", functools.partial(ProjPlusModel, **PROJ))


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    """(checkpoint set, its config overrides) with both packages patched
    for the module's tests."""
    from gaussianip_tpu_torch.diffusion.clip import (CLIPTextConfig,
                                                     CLIPTextModel,
                                                     CLIPVisionConfig,
                                                     CLIPVisionModel)
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.diffusion.unet import (ControlNetModel,
                                                     UNet2DConditionModel,
                                                     UNetConfig)
    from gaussianip_tpu_torch.diffusion.vae import AutoencoderKL, VAEConfig
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system.refine import REFINE_NEGATIVE_PROMPT
    from gaussianip_tpu_torch.system.standin import (random_faces,
                                                     write_checkpoint_set)

    g = torch.Generator().manual_seed(0)
    make = lambda ctor: pl.init_random_(ctor(), g)
    root = str(tmp_path_factory.mktemp("pretrained"))
    out = write_checkpoint_set(
        root,
        unet=make(lambda: UNet2DConditionModel(UNetConfig(
            lora_rank=4, ip_tokens=4, **UNET))),
        controlnet=make(lambda: ControlNetModel(UNetConfig(**UNET))),
        vae=make(lambda: AutoencoderKL(VAEConfig(**VAE))),
        proj=make(lambda: ProjPlusModel(**PROJ)),
        text_encoder=make(lambda: CLIPTextModel(CLIPTextConfig(
            vocab_size=1024, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=2))),
        vision_encoder=make(lambda: CLIPVisionModel(CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, patch_size=14, hidden_act="gelu"))),
        lpips=pl.build_random_lpips(0, "cpu"),
        texts=[pl.RECIPE_PROMPT, pl.RECIPE_NEGATIVE_PROMPT,
               REFINE_NEGATIVE_PROMPT],
        faces=random_faces(0, 96))
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        yield out


def _guidance_cfg(overrides) -> dict:
    from gaussianip_tpu_torch.utils.config import load_config

    return load_config(CONFIG, *overrides)["system"]["guidance"]


def test_load_real_models_matches_jax(tiny_set):
    """Every module bit-equal to from_flax of the JAX package's loaded
    tree; one guided step (loss and d loss / d rgb) within tolerance."""
    from gaussianip_tpu.guidance import ipa as jipa
    from gaussianip_tpu.guidance.prompts import (
        fake_text_encoder as jfake, make_prompt_embeddings as jmpe)
    from gaussianip_tpu.system import pipeline as jpl
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.diffusion.unet import (ControlNetModel,
                                                     UNet2DConditionModel)
    from gaussianip_tpu_torch.diffusion.vae import AutoencoderKL
    from gaussianip_tpu_torch.guidance import ipa
    from gaussianip_tpu_torch.guidance.prompts import (
        fake_text_encoder, make_prompt_embeddings)
    from gaussianip_tpu_torch.system import pipeline as pl

    g_cfg = _guidance_cfg(tiny_set["overrides"])
    jm = jpl.load_real_models(g_cfg, dtype=jnp.float32)
    models = pl.load_real_models(g_cfg, dtype=torch.float32, device="cpu")
    f32 = torch.float32
    for mod, ref in (
            (models.unet, from_flax(UNet2DConditionModel(
                pl.sd15_unet_config(0, 4, f32)), jm.unet_params)),
            (models.controlnet, from_flax(ControlNetModel(
                pl.sd15_unet_config(0, 0, f32)), jm.controlnet_params)),
            (models.vae, from_flax(AutoencoderKL(pl.VAEConfig(f32)),
                                   jm.vae_params))):
        sa, sb = mod.state_dict(), ref.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k

    rng = np.random.default_rng(0)
    b = 2
    rgb = rng.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32)
    aux = {"elevation": np.zeros(b, np.float32),
           "azimuth": np.array([60.0, -100.0], np.float32),
           "center": np.zeros(b, np.float32),
           "all_vis": np.zeros(b, np.float32),
           "camera_distances": np.full(b, 1.5, np.float32)}
    ip = rng.normal(0, 0.1, (3, 1, 4, 64)).astype(np.float32)
    jg = jipa.AHDSGuidance(
        jm, jmpe(jfake(77, 64), "a person", "bad quality", ""),
        jipa.ImageEmbeds(*(jnp.asarray(x) for x in ip)),
        jipa.GuidanceConfig(image_size=IMAGE))
    g = ipa.AHDSGuidance(
        models, make_prompt_embeddings(fake_text_encoder(77, 64), "a person",
                                       "bad quality", "", device="cpu"),
        ipa.ImageEmbeds(*(t(x) for x in ip)),
        ipa.GuidanceConfig(image_size=IMAGE))
    key = jax.random.PRNGKey(3)
    step = 100
    jaux = {k: jnp.asarray(v) for k, v in aux.items()}
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda r: jg(
        step, key, r, jnp.asarray(ctrl), jaux)["loss_sds"]))(
        jnp.asarray(rgb))
    x = t(rgb).requires_grad_(True)
    loss = g(step, jax_draws(key, b, IMAGE // 8), x, t(ctrl),
             {k: t(v) for k, v in aux.items()})["loss_sds"]
    loss.backward()
    assert float(jloss) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    jgrad = np.asarray(jgrad)
    assert np.abs(n(x.grad) - jgrad).max() <= GRAD_TOL * np.abs(jgrad).max()


def test_load_real_models_missing_file_raises(tiny_set, tmp_path):
    from gaussianip_tpu_torch.system import pipeline as pl

    g_cfg = dict(_guidance_cfg(tiny_set["overrides"]),
                 vae_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="--stub-guidance"):
        pl.load_real_models(g_cfg, dtype=torch.float32, device="cpu")


def _faces(tmp_path):
    from gaussianip_tpu_torch.system.standin import random_faces
    from gaussianip_tpu_torch.utils.saving import save_image

    a, b = random_faces(7, 120)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    save_image(pa, a[:, 10:110])  # 120 x 100: the centre crop is square
    save_image(pb, b)
    return pa, pb


def test_face_identity_fallback_matches_jax(tmp_path):
    """Both fallbacks in this process (no insightface here): the same
    embeddings and crops, bit for bit."""
    from gaussianip_tpu.system.pipeline import face_identity as jface
    from gaussianip_tpu_torch.system.pipeline import face_identity

    pa, pb = _faces(tmp_path)
    got, ref = face_identity(pa, pb), jface(pa, pb)
    for (e, c), (je, jc) in zip(got, ref):
        assert e.shape == (1, 512) and c.shape == (1, 224, 224, 3)
        assert e.dtype == je.dtype and np.array_equal(e, je)
        assert c.dtype == jc.dtype and np.array_equal(c, jc)
    assert not np.array_equal(got[0][0], got[1][0])


def test_face_identity_fallback_needs_pil(tmp_path, monkeypatch):
    from gaussianip_tpu_torch.system.pipeline import face_identity

    pa, pb = _faces(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        face_identity(pa, pb)


def test_load_lpips_matches_jax(lpips_ckpts):  # noqa: F811
    from gaussianip_tpu.system.pipeline import load_lpips as jload
    from gaussianip_tpu_torch.system.pipeline import load_lpips

    vp, lp = lpips_ckpts
    cfg = {"lpips_vgg_path": vp, "lpips_lin_path": lp}
    fn, jfn = load_lpips(cfg, "cpu"), jload(cfg)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = fn(t(x), t(y)).numpy()
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y)))
    assert (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=LPIPS_RTOL)
    assert not any(p.requires_grad for p in fn.parameters())


def test_load_lpips_absent_warns_none(caplog):
    from gaussianip_tpu.system.pipeline import load_lpips as jload
    from gaussianip_tpu_torch.system.pipeline import load_lpips

    cfg = {"lpips_vgg_path": "/nonexistent/vgg.pth",
           "lpips_lin_path": "/nonexistent/lin.pth"}
    with caplog.at_level(logging.WARNING, logger="gaussianip_tpu_torch"):
        assert load_lpips(cfg, "cpu") is None
    assert "L1 ONLY" in caplog.text
    assert jload(cfg) is None


# the keys of scripts/eval_avatar.py's EVAL.json with both LPIPS files
EVAL_KEYS = {"n_views", "render_size", "psnr", "ssim", "l1", "ply",
             "lpips_vgg", "id_similarity", "id_similarity_backend"}
TINY = ["system.height=32", "system.width=32", "system.ori_height=64",
        "system.ori_width=64", "system.pts_num=256", "system.capacity=1024",
        "data.batch_size=2", "data.eval_height=32", "data.eval_width=32",
        "data.n_test_views=2", "trainer.log_every_n_steps=1",
        "trainer.val_check_interval=1", "trainer.ckpt_every_n_steps=1"]


def test_cli_real_weights_stages(tiny_set, tmp_path, monkeypatch, caplog):
    """`python -m gaussianip_tpu_torch.launch` without --stub-guidance on
    the CPU: stages 1 -> 2 -> 3 (2 steps each) from the tiny set, LPIPS
    loaded in stage 3, then eval_avatar's EVAL.json."""
    from gaussianip_tpu_torch import eval_avatar, launch
    from gaussianip_tpu_torch.system import pipeline as pl

    lpips_loaded = []
    load_lpips = pl.load_lpips
    monkeypatch.setattr(pl, "load_lpips", lambda *a, **k: lpips_loaded.append(
        load_lpips(*a, **k)) or lpips_loaded[-1])
    log = str(tmp_path / "logs")
    args = ["--config", CONFIG, "--cur_time", "real", "--device", "cpu",
            f"system.log_path={log}", *TINY, *tiny_set["overrides"]]
    with caplog.at_level(logging.WARNING, logger="gaussianip_tpu_torch"):
        launch.main([*args, "--train", "--stage", "stage1",
                     "--max_steps", "2"])
        launch.main([*args, "--stage", "stage2"])
        launch.main([*args, "--train", "--stage", "stage3",
                     "--max_steps", "2"])
    assert "fallback face identity" in caplog.text  # no insightface here
    assert "SMPL-X model not found" in caplog.text
    root = os.path.join(log, "real")
    with open(os.path.join(root, "run.json")) as f:
        m = json.load(f)
    for k, v in {"stage1": "done", "stage1_steps": 2, "stage2": "done",
                 "stage3": "done", "device": "cpu",
                 "compute_dtype": "float32"}.items():
        assert m[k] == v, k
    assert os.path.exists(m["final_ply"])
    assert len(lpips_loaded) == 1 and lpips_loaded[0] is not None
    with np.load(os.path.join(root, "after_refine.npz")) as d:
        assert d["refined_rgbs_small"].shape == (32, 64, 64, 3)
    assert len(os.listdir(os.path.join(root, "text_cache"))) == 16

    files = tiny_set["files"]
    out = eval_avatar.main(["--run", root, "--config", CONFIG, "--device",
                            "cpu", "--face", files["face"], "--lpips-vgg",
                            files["lpips_vgg"], "--lpips-lin",
                            files["lpips_lin"]])
    with open(os.path.join(root, "EVAL.json")) as f:
        assert json.load(f) == out
    assert set(out) == EVAL_KEYS
    assert out["id_similarity_backend"] == "fallback"
    assert np.isfinite([out["psnr"], out["ssim"], out["l1"],
                        out["lpips_vgg"]]).all()
