"""The port's avatar benchmark (python -m gaussianip_tpu_torch.bench_pipeline)
on the CPU at tiny sizes.

  * Its scenes against the JAX package on the same numpy draws: the
    avatar of scripts/bench_pipeline.py (Skeleton on make_test_model,
    sampled points, create_from_pcd at capacity 1 << 17) and bench.py's
    capsule (create_from_pcd at capacity n, its opacities), every field
    within 1e-6: the scales as the mean squared 3-NN distance they encode,
    exp(2 scaling), which each package computes in float32 by the
    |x|^2 + |y|^2 - 2 x.y expansion (as tests/test_torch_ops.py holds it).
  * bench_stage1/2/3, bench_render and bench_denoise on the tiny stub
    stack (tiny_unet_config, tiny_vae_config) at 16-64^2, 2000 points and
    2 steps each: every key present and finite, the steps counted.
  * main() end to end on the CPU with the module's sizes shrunk: one JSON
    line with every key, written to --out and never to PIPELINE_BENCH.json;
    --device cuda raises without a card.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS, n

torch.set_num_threads(1)
N = 2000
CAP = 4096
RES = 64
FIELD_TOL = 1e-6


def _assert_state_close(got, ref):
    assert got.n_active == int(ref.n_active)
    assert got.capacity == ref.xyz.shape[0]
    for f in PARAM_FIELDS:
        a, b = n(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        if f == "scaling":
            a, b = np.exp(2.0 * a), np.exp(2.0 * b)
        assert a.size == 0 or np.max(np.abs(a - b)) <= FIELD_TOL, f


def _finite(d: dict, keys):
    for k in keys:
        assert k in d, k
        assert math.isfinite(d[k]), (k, d[k])


def test_avatar_matches_jax():
    import jax.numpy as jnp

    from gaussianip_tpu.human.skeleton import Skeleton
    from gaussianip_tpu.human.smplx_jax import make_test_model
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.knn import mean_dist2_3nn
    from gaussianip_tpu_torch.bench_pipeline import CAPACITY, avatar

    sk, gs = avatar("cpu", np.random.default_rng(0), N, CAPACITY)
    jsk = Skeleton(_test_model=make_test_model(np.random.default_rng(0),
                                               n_verts=2000, n_faces=3000))
    jsk.forward_smplx()
    jsk.scale(-10)
    pts = jsk.sample_smplx_points(N)
    ref = create_from_pcd(pts, np.full((N, 3), 0.5, np.float32), 1 << 17,
                          mean_dist2_3nn(jnp.asarray(pts)))
    assert CAPACITY == 1 << 17
    np.testing.assert_allclose(np.asarray(sk.points3d),
                               np.asarray(jsk.points3d), atol=FIELD_TOL)
    _assert_state_close(gs, ref)


def test_capsule_scene_matches_jax():
    import jax.numpy as jnp

    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.ops.knn import mean_dist2_3nn
    from gaussianip_tpu_torch.bench_pipeline import (capsule_points,
                                                     capsule_scene)

    gs = capsule_scene("cpu", N)
    # bench.py's draws, in its order
    rng = np.random.default_rng(0)
    z = rng.uniform(-0.85, 0.85, N)
    th = rng.uniform(0, 2 * np.pi, N)
    r = 0.25 * np.sqrt(np.maximum(0.0, 1 - (z / 0.9) ** 2)) + 0.03
    pts = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    cols = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ref = create_from_pcd(pts, cols, N, mean_dist2_3nn(jnp.asarray(pts),
                                                       block=4096))
    ref = ref.replace(opacity=jnp.asarray(
        rng.uniform(-1.0, 2.5, (N, 1)).astype(np.float32)))
    np.testing.assert_array_equal(capsule_points(N)[0], pts)
    _assert_state_close(gs, ref)


@pytest.fixture(scope="module")
def stack():
    from gaussianip_tpu_torch.bench_pipeline import avatar
    from gaussianip_tpu_torch.system.pipeline import build_stub_guidance_stack

    sk, gs = avatar("cpu", np.random.default_rng(0), N, CAP)
    guidance = build_stub_guidance_stack("a person", "bad quality",
                                         image_size=RES, device="cpu")
    return sk, gs, guidance


LAUNCH_KEYS = {"K1", "K2", "K3", "K3_hopper", "K3_general", "K4_fwd",
               "K4_bwd", "K5_fwd", "K5_bwd"}


def test_bench_stage1(stack):
    from gaussianip_tpu_torch.bench_pipeline import STAGE1_STEPS, bench_stage1

    sk, gs, guidance = stack
    x0 = gs.xyz.clone()
    r = bench_stage1(gs, sk, guidance, res=RES, batch=2, warmup=1, steps=2)
    _finite(r, ["stage1_first_step_s", "stage1_step_ms",
                "stage1_2400_steps_min", "stage1_loss_last"])
    assert r["stage1_steps"] == 4
    assert r["stage1_2400_steps_min"] == pytest.approx(
        r["stage1_step_ms"] * STAGE1_STEPS / 6e4)
    assert set(r["launches_stage1"]) == LAUNCH_KEYS
    assert torch.equal(gs.xyz, x0)  # the next stage starts from the avatar


def test_bench_stage2(stack, monkeypatch):
    from gaussianip_tpu_torch.bench_pipeline import bench_stage2
    from gaussianip_tpu_torch.system import refine
    from gaussianip_tpu_torch.system.pipeline import refine_models

    monkeypatch.setattr(refine, "CROP_Y", (0, 16))
    monkeypatch.setattr(refine, "CROP_X", (2, 14))
    _, _, guidance = stack
    models = refine_models(guidance)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((32, 16, 16, 3), generator=gen)
    controls = torch.rand((32, 16, 16, 3), generator=gen)
    s = 16 // models.vae.cfg.downscale
    ctx = {nm: torch.zeros((2, 81, 32)) for nm in refine.VIEW_NAME_ALL}
    r = bench_stage2(models, images, controls, ctx,
                     torch.randn((4, s, s), generator=gen))
    _finite(r, ["stage2_total_s_incl_compile", "stage2_wall_s"])
    assert r["stage2_calls"] == 2 and r["stage2_res"] == 16
    assert r["stage2_targets"] == [32, 8, 6, 3]
    assert set(r["launches_stage2"]) == LAUNCH_KEYS


def test_bench_stage3(stack):
    from gaussianip_tpu_torch.bench_pipeline import bench_stage3
    from gaussianip_tpu_torch.system.pipeline import build_random_lpips

    _, gs, _ = stack
    targets = torch.rand((32, RES // 2, RES // 2, 3),
                         generator=torch.Generator().manual_seed(1))
    r = bench_stage3(gs, build_random_lpips(0, "cpu"), targets, res=RES,
                     steps=2, crop={"crop_y": (0, RES), "crop_x": (0, RES)})
    _finite(r, ["stage3_wall_s", "stage3_loss_last"])
    assert r["stage3_steps"] == 2 and r["stage3_res"] == RES
    assert r["stage3_n_active"] == N


def test_bench_render():
    from gaussianip_tpu_torch.bench_pipeline import (bench_render,
                                                     capsule_scene)

    r = bench_render(capsule_scene("cpu", N), res=RES, train_res=32,
                     iters=1)
    _finite(r, ["fwd_ms", "fwd_bwd_ms", "train_step_render_512_b4_ms",
                "splat_render_fwd_bwd_1024px_100k", "k1_ms", "k2_ms",
                "k1_bound_ms", "k2_bound_ms", "k1_share_of_bound",
                "k2_share_of_bound"])
    assert r["n_live_instances"] > 0 and r["pairs"] > 0
    assert r["k1_bound_by"] in ("bytes", "operations")
    assert r["splat_render_fwd_bwd_1024px_100k"] == pytest.approx(
        1e3 / r["fwd_bwd_ms"])


def test_bench_denoise(stack):
    from gaussianip_tpu_torch.bench_pipeline import bench_denoise

    _, _, guidance = stack
    r = bench_denoise(guidance, batch=3, iters=1)
    _finite(r, ["unet_denoise_ms", "unet_denoise_steps_per_s"])
    assert r["unet_denoise_batch"] == 3
    assert r["unet_denoise_latent"] == RES // guidance.models.vae.cfg.downscale


def test_main_cpu_line(tmp_path, monkeypatch, capsys):
    """main(["123", "--device", "cpu", "--out", ...]) at tiny sizes: one
    JSON line with every key, finite, written to --out; nothing written
    to PIPELINE_BENCH.json."""
    from gaussianip_tpu_torch import bench_pipeline as bp
    from gaussianip_tpu_torch.system import pipeline, refine

    for k, v in (("N_POINTS", N), ("CAPACITY", CAP), ("HIRES", 32),
                 ("STAGE1_RES", 32), ("STAGE1_BATCH", 2),
                 ("STAGE1_WARMUP", 1), ("STAGE1_TIMED", 1),
                 ("TIMED_CALLS", 1)):
        monkeypatch.setattr(bp, k, v)
    monkeypatch.setattr(refine, "CROP_Y", (0, 32))
    monkeypatch.setattr(refine, "CROP_X", (0, 32))
    stub = pipeline.build_stub_guidance_stack
    monkeypatch.setattr(pipeline, "build_random_sd15_guidance",
                        lambda seed, device: stub("a person", "bad",
                                                  image_size=32, seed=seed,
                                                  device=device))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "line.json"
    line = bp.main(["123", "--device", "cpu", "--out", str(out),
                    "--stage3-steps", "2", "--commit", "abc"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text()) == json.loads(
        json.dumps(line))
    assert not os.path.exists(tmp_path / "PIPELINE_BENCH.json")
    _finite(line, ["stage1_step_ms", "stage1_2400_steps_min",
                   "stage1_first_step_s", "stage2_total_s_incl_compile",
                   "stage2_wall_s", "stage3_wall_s", "pipeline_total_min",
                   "vs_reference_40min", "splat_render_fwd_bwd_1024px_100k",
                   "fwd_ms", "fwd_bwd_ms", "train_step_render_512_b4_ms",
                   "unet_denoise_ms", "unet_denoise_steps_per_s", "k1_ms",
                   "k2_ms", "k1_share_of_bound", "k2_share_of_bound"])
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert line["commit"] == "abc" and line["stages"] == "123"
    assert line["capacity"] == CAP and line["stage3_steps"] == 2
    assert line["stage2_targets"] == [32, 16, 16, 3]
    for stage in ("stage1", "stage2", "stage3", "render", "denoise"):
        assert set(line[f"launches_{stage}"]) == LAUNCH_KEYS
    assert line["cut"] == {"stage1": "3 of 2400 steps run, the rest "
                                     "projected",
                           "stage3": "2 of 800 steps"}


def test_main_refuses_pipeline_bench_json(tmp_path):
    from gaussianip_tpu_torch.bench_pipeline import parse_args

    with pytest.raises(SystemExit):
        parse_args(["--out", str(tmp_path / "PIPELINE_BENCH.json")])


def test_main_refuses_missing_card():
    from gaussianip_tpu_torch.bench_pipeline import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["123", "--device", "cuda"])
