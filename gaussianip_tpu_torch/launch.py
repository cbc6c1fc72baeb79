"""The port's command line (port of the repository's launch.py):

  python -m gaussianip_tpu_torch.launch --config configs/exp.yaml --train \
      --cur_time <id> --stage stage1 [--stub-guidance] [dotted.key=value ...]

then `--stage stage2` and `--stage stage3` with the same `--cur_time`.
Each stage reads and writes <system.log_path>/<cur_time>/: run.json (the
manifest of stage progress), ckpt/stage1_latest.npz, before_refine.npz,
after_refine.npz, the .ply files, save/*.png, metrics.csv and the test
video, in the layouts launch.py writes, so that either package continues
a run directory the other started.

The port runs on the card (`--device cuda`, the default; it raises when
there is none) at bf16 compute, or on the CPU (`--device cpu`) at float32,
the JAX package's dtype. TF32 is off on the card
(gaussianip_tpu_torch.set_precision_policy). The run manifest records the
device, the compute dtype and the precision policy.

Without `--stub-guidance` the stages load the released checkpoints named
by `system.guidance.*_path` (system/pipeline.py's loaders): the SD1.5
UNet with the IP-Adapter LoRA folded in, the ControlNet, the VAE, the
CLIP text and image encoders, the face identity (insightface, or a loudly
warned fallback) and, in stage 3, LPIPS from `system.lpips_vgg_path` /
`system.lpips_lin_path` (absent: a loud warning and L1 alone). A missing
SMPL-X model falls back to the synthetic body with a warning.
`--stub-guidance` runs the tiny random stack and the synthetic body
instead.

`--export` turns the trained .ply (`--resume_from`, else the manifest's
final_ply, else save/last.ply) into a textured OBJ/MTL/PNG under
export/, with `system.exporter`'s settings (ops/mesh_export.py), and
records the paths in the manifest.

Data parallel (`--devices auto|1|N`, launch.py's batch-vs-mesh policy):
each stage runs in N processes (parallel/mesh.py:spawn) that split the
camera / view batch and keep the gaussian state replicated. On the card
N is at most the visible cards, one card a rank, over NCCL; `--device cpu
--devices N` runs N gloo ranks on the CPU. `auto` is every visible card on
`--device cuda` and 1 on the CPU. The stage-1 camera batch and stage 3's
refine_train_bs round up to a multiple of N; with `--recipe_batch` they
stay as configured and N falls to the largest divisor of the stage's
batch (stage 1: data.batch_size, stage 2: refine_train_bs). Stage 3 takes
N without that cap, as launch.py does. Rank 0 writes the run directory,
the others wait for it; a rank that fails fails the command.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

import gaussianip_tpu_torch as gt


def _check_args(args):
    """Refuse the card when it is missing, and more ranks than cards;
    nothing falls back quietly."""
    import torch

    devices = str(getattr(args, "devices", "auto"))
    if devices != "auto" and int(devices) < 1:
        raise ValueError(f"--devices {devices}: at least 1")
    device = getattr(args, "device", "cuda")
    if device == "cuda":
        visible = torch.cuda.device_count()
        if devices != "auto" and int(devices) > visible:
            raise RuntimeError(
                f"--devices {devices}: {visible} CUDA device(s) visible; "
                "the port runs one card a rank")
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible "
                               "(pass --device cpu to run on the CPU)")


def resolve_world(args, recipe_batch: int = 0) -> int:
    """The data-parallel world size (launch.py's resolve_mesh): `--devices
    1` one process, `auto` every visible card on --device cuda and 1 on the
    CPU, N as given; with --recipe_batch it falls to the largest divisor of
    recipe_batch, so that the configured batch stays exact."""
    devices = str(getattr(args, "devices", "auto"))
    if devices == "auto":
        import torch

        n = torch.cuda.device_count() if args.device == "cuda" else 1
    else:
        n = int(devices)
    if recipe_batch and getattr(args, "recipe_batch", False):
        while recipe_batch % n:
            n -= 1
    return max(n, 1)


def scale_batch(bs: int, world: int) -> int:
    """A batch size rounded up to a multiple of the world size (launch.py's
    _scale_batch: every rank renders at least one view a step)."""
    return -(-bs // world) * world


def compute_dtype(device):
    """bf16 on the card (K3 takes bf16 only), float32 on the CPU."""
    import torch

    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def _rank_device(args, group) -> str:
    """The stage's device: the rank's, else --device."""
    return str(group.device) if group is not None else getattr(
        args, "device", "cuda")


def build_skeleton(system_cfg, stub: bool, device="cuda"):
    from .human.skeleton import Skeleton

    smplx_path = system_cfg.get("smplx_path", "")
    if not stub and smplx_path and (
        os.path.exists(smplx_path)
        or os.path.exists(os.path.join(smplx_path, "SMPLX_NEUTRAL.npz"))
    ):
        sk = Skeleton(smplx_path, gender=system_cfg.get("gender", "neutral"),
                      apose=system_cfg.get("apose", True), device=device)
    else:
        from .human.smplx import make_test_model

        if not stub:
            gt.warn(f"SMPL-X model not found at '{smplx_path}' — using the "
                    f"synthetic test body (geometry will be a blob)")
        sk = Skeleton(_test_model=make_test_model(
            np.random.default_rng(0), n_verts=2000, n_faces=3000,
            device=device), apose=system_cfg.get("apose", True))
    sk.forward_smplx()
    sk.scale(-10)
    return sk


def camera_config(cfg, height=None, width=None):
    """The camera sampler's config from the `data:` section (the
    registry's random-camera-datamodule)."""
    from . import components  # noqa: F401  (registers the type names)

    return gt.find(cfg["data_type"])(cfg["data"], height, width).cfg


def _stub_stack(cfg, prompt: str, negative_prompt: str, device: str):
    from .system import pipeline as pl

    return pl.build_stub_guidance_stack(
        prompt, negative_prompt,
        image_size=int(cfg["system"].get("stub_image_size", 64)),
        device=device, dtype=compute_dtype(device))


def _face_identity(g_cfg, group):
    """pipeline.face_identity of the face photo and the irrelevant face as
    rank 0 computes it: without insightface its fallback embedding is
    seeded by Python's str hash, which differs from process to process, so
    each rank would otherwise condition on another identity."""
    import torch

    from .parallel.mesh import replicated
    from .system import pipeline as pl

    faces = pl.face_identity(g_cfg["pil_image_faceid_path"],
                             g_cfg["irr_pil_image_path"])
    if group is None:
        return faces
    a = [x.cpu().numpy() for x in replicated(group, [
        torch.as_tensor(x, device=group.device) for pair in faces
        for x in pair])]
    return (a[0], a[1]), (a[2], a[3])


def _real_stage1_guidance(cfg, dirs, device: str, group=None):
    """The stage-1 guidance from the released checkpoints: the models, the
    prompt embeddings (cached under the run's text_cache/ by the md5 of
    model name and prompt), the identity tokens of the face, the
    irrelevant face and the zero image at ipa_faceid_s_scale."""
    import torch

    from .guidance.ipa import (AHDSGuidance, GuidanceConfig,
                               compute_image_embeds)
    from .guidance.prompts import make_prompt_embeddings
    from .system import pipeline as pl

    sys_cfg = cfg["system"]
    g_cfg = sys_cfg["guidance"]
    dt = compute_dtype(device)
    models = pl.load_real_models(g_cfg, dtype=dt, device=device)
    model_name = g_cfg["pretrained_realistic_model_name_or_path"]
    pe = make_prompt_embeddings(
        pl.load_text_encoder(model_name, device),
        sys_cfg["prompt_processor"]["prompt"],
        g_cfg["negative_prompt_faceid"], g_cfg.get("null_prompt", ""),
        cache_dir=dirs.path("text_cache", "x")[:-1], model_name=model_name,
        device=device)
    img_enc = pl.load_image_encoder(g_cfg["image_encoder_faceid_path"],
                                    device)
    (pos_e, pos_face), (irr_e, irr_face) = _face_identity(g_cfg, group)
    proj = pl.load_ip_adapter_proj(g_cfg["ip_ckpt_faceid_v2_path"],
                                   device=device)
    t = lambda a: torch.as_tensor(a, device=device)
    img_embeds = compute_image_embeds(
        proj, t(pos_e), t(irr_e), img_enc(pos_face), img_enc(irr_face),
        img_enc(np.zeros_like(pos_face)),
        s_scale=float(g_cfg.get("ipa_faceid_s_scale", 0.4)))
    return AHDSGuidance(models, pe, img_embeds, GuidanceConfig(
        guidance_scale=float(g_cfg.get("guidance_scale", 7.5)),
        guidance_rescale=float(g_cfg.get("guidance_rescale", 0.75)),
        ipa_scale=float(g_cfg.get("ipa_faceid_scale", 0.5)),
        use_anpg=bool(g_cfg.get("use_anpg", True)),
        grad_clip_pixel=bool(g_cfg.get("grad_clip_pixel", True)),
        grad_clip_threshold=float(g_cfg.get("grad_clip_threshold", 1.0))))


def _real_refine_inputs(cfg, device: str, group=None):
    """Stage 2's models, text encoder and identity tokens from the
    released checkpoints: the positive face's tokens for the cond row, the
    zero face's for the uncond row (ProjPlusModel at s_scale 0.5 with the
    shortcut)."""
    import torch

    from .system import pipeline as pl
    from .system.refine import RefineModels, refine_identity_tokens

    g_cfg = cfg["system"]["guidance"]
    models = RefineModels(*pl.load_real_models(
        g_cfg, dtype=compute_dtype(device), device=device))
    enc = pl.load_text_encoder(
        g_cfg["pretrained_realistic_model_name_or_path"], device)
    img_enc = pl.load_image_encoder(g_cfg["image_encoder_faceid_path"],
                                    device)
    (pos_e, pos_face), _ = _face_identity(g_cfg, group)
    proj = pl.load_ip_adapter_proj(g_cfg["ip_ckpt_faceid_v2_path"],
                                   device=device)
    ip_cond, ip_uncond = refine_identity_tokens(
        proj, torch.as_tensor(pos_e, device=device), img_enc(pos_face),
        img_enc(np.zeros_like(pos_face)))
    return models, enc, ip_cond, ip_uncond


def run_stage1(cfg, dirs, args, group=None):
    """Stage 1; `group`: this rank's data-parallel group (None: one
    process)."""
    from dataclasses import replace

    import torch

    from .data.cameras import camera_from_c2w
    from .data.sampler import eval_orbit_batch, refine_orbit_batch
    from .model.adam import AdamHyper
    from .model.gaussians import create_from_pcd
    from .model.ply import state_to_ply
    from .ops.knn import mean_dist2_3nn
    from .parallel.mesh import (barrier, check_replicated, is_main,
                                replicated, world_size)
    from .render.render import RenderConfig, render
    from .system.refine import render_refine_views
    from .system.stage1 import Stage1Config, init_train_state, train_stage1
    from .utils import native_io
    from .utils.checkpoint import load_train_state_npz, save_train_state_npz
    from .utils.logging import MetricsLogger
    from .utils.saving import save_image

    _check_args(args)
    dev = _rank_device(args, group)
    main = is_main(group)
    sys_cfg = cfg["system"]
    sk = build_skeleton(sys_cfg, args.stub_guidance, dev)

    n_pts = int(sys_cfg.get("pts_num", 100000))
    pts = sk.sample_smplx_points(n_pts, seed=cfg.get("seed", 42))
    colors = np.full((n_pts, 3), 0.5, np.float32)
    capacity = int(sys_cfg.get("capacity", max(1 << 17, 2 * n_pts)))
    d2 = mean_dist2_3nn(torch.as_tensor(pts, device=dev))
    gs = create_from_pcd(pts, colors, capacity, d2, device=dev)
    ts = init_train_state(gs)

    s1 = Stage1Config(
        render_height=int(sys_cfg.get("height", 512)),
        render_width=int(sys_cfg.get("width", 512)),
        bg_white=bool(sys_cfg.get("bg_white", False)),
        densify_prune_start_step=int(sys_cfg["densify_prune_start_step"]),
        densify_prune_end_step=int(sys_cfg["densify_prune_end_step"]),
        densify_prune_interval=int(sys_cfg["densify_prune_interval"]),
        densify_prune_min_opacity=float(sys_cfg["densify_prune_min_opacity"]),
        densify_prune_world_size_threshold=float(
            sys_cfg["densify_prune_world_size_threshold"]),
        prune_only_start_step=int(sys_cfg["prune_only_start_step"]),
        prune_only_end_step=int(sys_cfg["prune_only_end_step"]),
        prune_only_interval=int(sys_cfg["prune_only_interval"]),
        prune_opacity_threshold=float(sys_cfg["prune_opacity_threshold"]),
        prune_world_size_threshold=float(sys_cfg["prune_world_size_threshold"]),
        max_grad=float(sys_cfg["max_grad"]),
        max_steps=int(cfg["trainer"]["max_steps"]),
    )
    cam_cfg = camera_config(cfg, s1.render_height, s1.render_width)
    cam_cfg = replace(cam_cfg, batch_size=scale_batch(cam_cfg.batch_size,
                                                      world_size(group)))
    if args.stub_guidance:
        guidance = _stub_stack(cfg, sys_cfg["prompt_processor"]["prompt"],
                               sys_cfg["prompt_processor"]["negative_prompt"],
                               dev)
    else:
        guidance = _real_stage1_guidance(cfg, dirs, dev, group)

    # 512^2 training renders: footprints fit a 4x4-tile budget (radii halve
    # vs 1024^2); eval/refine/stage3 use the default d_max=25
    rcfg = RenderConfig(d_max=16)
    n_steps = args.max_steps or s1.max_steps
    t0 = time.time()
    val_every = int(cfg["trainer"].get("val_check_interval", 100))
    eval_batch = eval_orbit_batch(cam_cfg, "val", dev)

    @torch.no_grad()
    def save_val(i, ts_state):
        eh, ew = cam_cfg.eval_height, cam_cfg.eval_width
        cams_v = camera_from_c2w(eval_batch.c2w[0:1], eval_batch.fovy[0:1],
                                 eh, ew)
        img = render(ts_state.gaussians, cams_v, torch.zeros(3, device=dev),
                     rcfg).rgb[0].cpu().numpy()
        p = dirs.path("save", f"it{i}-0_rgb.png")
        # the async native writer keeps the train loop moving
        if not native_io.write_png_async(p, img):
            save_image(p, img)

    mlog = MetricsLogger(dirs.root) if main else None

    def log(i, m):
        gt.info(f"step {i}: loss={m['loss']:.4f} sds={m['loss_sds']:.4f} "
                f"n={int(m['n_active'])} ({time.time() - t0:.0f}s)")
        mlog.log(i, m)

    # checkpoint / resume: a periodic npz of the whole TrainState in the
    # JAX package's layout; --resume continues from the latest one
    ckpt_path = dirs.path("ckpt", "stage1_latest.npz")
    resume_from = getattr(args, "resume_from", None)
    if getattr(args, "resume", False) or resume_from:
        src = resume_from or ckpt_path
        if os.path.exists(src):
            ts = load_train_state_npz(src, ts)
            gt.info(f"resumed stage 1 from {src} at step {ts.step}")
        else:
            gt.info(f"--resume: no checkpoint at {src}; starting fresh")
        n_steps = max(n_steps - ts.step, 0)
    ts = replicated(group, ts)

    def save_ckpt(i, ts_state):
        save_train_state_npz(ckpt_path, ts_state)

    # every rank draws from the same seed: the whole batch, then its rows
    generator = torch.Generator(device=dev).manual_seed(int(cfg.get("seed",
                                                                    42)))
    ts = train_stage1(
        ts, s1, cam_cfg, rcfg, AdamHyper(), guidance, sk.points3d,
        generator, n_steps=n_steps, log_fn=log if main else None,
        log_every=int(cfg["trainer"].get("log_every_n_steps", 100)),
        val_every=val_every, val_fn=save_val if main else None,
        ckpt_every=int(cfg["trainer"].get("ckpt_every_n_steps", 500)),
        ckpt_fn=save_ckpt if main else None, group=group)
    check_replicated(group, ts, "stage 1")
    if not main:
        barrier(group)  # rank 0 writes the handoff
        return
    mlog.close()

    # the 32 refine views and their pose maps (the before_refine handoff)
    n_views = int(sys_cfg.get("refine_n_views", 32))
    H = int(sys_cfg.get("ori_height", 1024))
    orbit = refine_orbit_batch(
        n_views, float(sys_cfg["refine_elevation"]),
        float(sys_cfg["refine_camera_distance"]),
        float(sys_cfg["refine_fovy_deg"]), H,
        int(sys_cfg.get("ori_width", 1024)), dev)
    images, poses = render_refine_views(ts.gaussians, orbit, sk.points3d,
                                        H, H, rcfg)
    rgb_np, poses_np = images.cpu().numpy(), poses.cpu().numpy()
    np.savez(dirs.path("before_refine.npz"), images=rgb_np,
             control_images=poses_np)
    for i in range(n_views):
        save_image(dirs.path("save", f"raw_rgb_{i}.png"), rgb_np[i])

    total_steps = ts.step  # global step (resume-aware)
    ply_path = dirs.path(f"it{total_steps}.ply")
    state_to_ply(ts.gaussians, ply_path)
    dirs.manifest(stage1="done", stage1_steps=total_steps, ply=ply_path,
                  stage1_wall_s=round(time.time() - t0, 1))
    gt.info(f"stage 1 done in {time.time() - t0:.0f}s -> {ply_path}")
    barrier(group)


def run_stage2(cfg, dirs, args, group=None):
    """In-process VCR refinement of the 32 handoff views; with a
    data-parallel `group` the views split over the ranks (dense groups of
    8, as launch.py passes on a mesh)."""
    import torch

    from .guidance.prompts import fake_text_encoder
    from .ops.resize import linear_resize
    from .parallel.mesh import barrier, is_main
    from .system.refine import (RefineModels, crop_and_downsample,
                                refine_contexts, refine_views)
    from .utils.saving import save_image

    _check_args(args)
    dev = _rank_device(args, group)
    sys_cfg = cfg["system"]
    with np.load(dirs.path("before_refine.npz")) as data:
        images = torch.as_tensor(data["images"], device=dev)
        control = torch.as_tensor(data["control_images"], device=dev)

    if args.stub_guidance:
        sz = int(sys_cfg.get("stub_image_size", 64))
        g = _stub_stack(cfg, "person", "bad", dev)
        models = RefineModels(*g.models)
        enc = fake_text_encoder(77, 32)
        resize = lambda x: linear_resize(x.permute(0, 3, 1, 2), sz,
                                         sz).permute(0, 2, 3, 1)
        images, control = resize(images), resize(control)
        ip_cond = ip_uncond = np.zeros((4, 32), np.float32)
    else:
        models, enc, ip_cond, ip_uncond = _real_refine_inputs(cfg, dev,
                                                              group)
    contexts = refine_contexts(enc, sys_cfg["prompt_processor"]["prompt"],
                               ip_cond, ip_uncond, dev)

    # the shared forward-diffusion draw of every view's latents
    s = images.shape[1] // models.vae.cfg.downscale
    noise = torch.randn((4, s, s), device=dev, generator=torch.Generator(
        device=dev).manual_seed(2024))
    refined = refine_views(models, images, control, contexts, noise,
                           dense_batch=4 if group is None else 8,
                           group=group)
    if not is_main(group):
        barrier(group)  # rank 0 writes the views
        return
    refined_np = refined.cpu().numpy()  # one device pull, not 32
    for i in range(refined_np.shape[0]):
        save_image(dirs.path("save", f"refined_rgb_{i}.png"), refined_np[i])
    small = crop_and_downsample(refined) if refined.shape[1] >= 1024 \
        else refined
    np.savez(dirs.path("after_refine.npz"),
             refined_rgbs_small=small.cpu().numpy())
    dirs.manifest(stage2="done")
    gt.info(f"stage 2 done -> {dirs.path('after_refine.npz')}")
    barrier(group)


def run_stage3(cfg, dirs, args, group=None):
    """Stage 3; `group`: this rank's data-parallel group (None: one
    process)."""
    import torch

    from dataclasses import replace

    from .data.sampler import eval_orbit_batch, refine_orbit_batch
    from .model.adam import AdamHyper
    from .model.ply import state_from_ply, state_to_ply
    from .parallel.mesh import (barrier, check_replicated, is_main,
                                replicated, world_size)
    from .render.render import RenderConfig
    from .system.stage1 import init_train_state
    from .system.stage3 import (Stage3Config, draw_view_ids,
                                render_turntable, train_stage3)
    from .utils.logging import MetricsLogger
    from .utils.saving import save_image, save_video

    _check_args(args)
    dev = _rank_device(args, group)
    main = is_main(group)
    sys_cfg = cfg["system"]
    gs = state_from_ply(dirs.manifest_get("ply"), device=dev)
    ts = replicated(group, init_train_state(gs))
    with np.load(dirs.path("after_refine.npz")) as data:
        refined = torch.as_tensor(data["refined_rgbs_small"], device=dev)

    H = int(sys_cfg.get("ori_height", 1024))
    if args.stub_guidance:
        H = max(refined.shape[1] * 2, 32)
    n_views = int(sys_cfg.get("refine_n_views", 32))
    orbit = refine_orbit_batch(
        n_views, float(sys_cfg["refine_elevation"]),
        float(sys_cfg["refine_camera_distance"]),
        float(sys_cfg["refine_fovy_deg"]), H, H, dev)
    cy, cx = (60, 890), (220, 800)
    if H != 1024:  # scale the crop window to the render size
        cy = (60 * H // 1024, max(890 * H // 1024, 60 * H // 1024 + 8))
        cx = (220 * H // 1024, max(800 * H // 1024, 220 * H // 1024 + 8))
    s3 = Stage3Config(
        height=H, width=H, crop_y=cy, crop_x=cx,
        refine_start_step=int(sys_cfg.get("refine_start_step", 2400)),
        max_steps=args.max_steps or int(cfg["trainer"]["max_steps"]),
        train_bs=scale_batch(int(sys_cfg.get("refine_train_bs", 4)),
                             world_size(group)),
        lambda_l1=float(sys_cfg.get("lambda_l1", 10)),
        lambda_lpips=float(sys_cfg.get("lambda_lpips", 15)),
        max_grad=float(sys_cfg["max_grad"]),
    )
    # 10 * L1 + 15 * LPIPS when the VGG / LPIPS checkpoints resolve (a loud
    # warning and L1 alone otherwise); the stub run is L1 alone
    lpips_fn = None
    if not args.stub_guidance:
        from .system.pipeline import load_lpips

        lpips_fn = load_lpips(sys_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    view_ids = draw_view_ids(gen, n_views, s3.train_bs, s3.max_steps, dev)
    split_noise = torch.randn((2, gs.capacity, 3), generator=gen, device=dev)
    t0 = time.time()
    mlog = MetricsLogger(dirs.root) if main else None

    def s3log(i, m):
        gt.info(f"s3 step {i}: loss={m['loss']:.4f}")
        mlog.log(i + s3.refine_start_step, m)

    ts = train_stage3(ts, s3, RenderConfig(), AdamHyper(), orbit, refined,
                      view_ids, split_noise, lpips_fn=lpips_fn,
                      log_fn=s3log if main else None, group=group)
    check_replicated(group, ts, "stage 3")
    if not main:
        barrier(group)  # rank 0 writes the turntable and the .ply
        return
    mlog.close()

    # the test orbit's video and the final ply
    cam_cfg = replace(camera_config(cfg), eval_height=min(H, 1024),
                      eval_width=min(H, 1024))
    test = eval_orbit_batch(cam_cfg, "test", dev)
    He = cam_cfg.eval_height
    frames = render_turntable(ts.gaussians, test, He, He,
                              RenderConfig()).cpu().numpy()
    for i in range(0, frames.shape[0], 16):
        save_image(dirs.path("save", "test", f"{i}.png"), frames[i])
    video = save_video(dirs.path("save", "test.mp4"), frames, fps=30)
    final_ply = dirs.path("save", "last.ply")
    state_to_ply(ts.gaussians, final_ply)
    dirs.manifest(stage3="done", final_ply=final_ply,
                  stage3_wall_s=round(time.time() - t0, 1), video=video)
    gt.info(f"stage 3 done in {time.time() - t0:.0f}s -> {final_ply}")
    barrier(group)


def run_export(cfg, dirs, args):
    """--export: the trained .ply -> a textured OBJ/MTL mesh (or a plain
    OBJ with system.exporter.fmt=obj). Returns the written paths."""
    from .model.ply import state_from_ply
    from .ops.mesh_export import export_avatar_mesh

    _check_args(args)
    ecfg = cfg["system"].get("exporter", {}) or {}
    ply = args.resume_from or dirs.manifest_get("final_ply") \
        or dirs.path("save", "last.ply")
    if not os.path.exists(ply):
        raise FileNotFoundError(
            f"--export needs a trained .ply; none at {ply} "
            "(pass --resume_from <path/to/.ply> or run stage 3 first)")
    state = state_from_ply(ply, device=getattr(args, "device", "cuda"))
    out_prefix = dirs.path("export", str(ecfg.get("save_name", "model")))
    paths = export_avatar_mesh(
        state, out_prefix,
        resolution=int(ecfg.get("resolution", 128)),
        density_thresh=float(ecfg.get("density_thresh", 1.0)),
        texture_size=int(ecfg.get("texture_size", 1024)),
        fmt=str(ecfg.get("fmt", "obj-mtl")),
    )
    dirs.manifest(export=paths)
    gt.info(f"export done -> {paths['obj']}")
    return paths


STAGES = {"stage1": run_stage1, "stage2": run_stage2, "stage3": run_stage3}


def run(stage: str, cfg, dirs, args):
    """One stage, in this process or, when the world size (resolve_world)
    is above 1, in that many ranks; the manifest then records world_size."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage}")
    sys_cfg = cfg["system"]
    world = resolve_world(args, {
        "stage1": int(cfg["data"].get("batch_size", 4)),
        "stage2": int(sys_cfg.get("refine_train_bs", 4)),
        "stage3": 0}[stage])
    if world == 1:
        STAGES[stage](cfg, dirs, args)
        return
    from .parallel.mesh import spawn

    cuda = args.device == "cuda"
    dirs.manifest(world_size=world)
    gt.info(f"data parallel over {world} ranks ("
            + ("NCCL, one card a rank)" if cuda else "gloo on the CPU)"))
    spawn(world, _rank_stage, stage, cfg, dirs.root, args,
          backend="nccl" if cuda else "gloo",
          devices=[f"cuda:{r}" for r in range(world)] if cuda else None)


def _rank_stage(group, stage: str, cfg, root: str, args):
    """What each rank of `run` runs."""
    from .utils import native_io
    from .utils.saving import RunDirs

    gt.set_precision_policy()
    np.random.seed(int(cfg.get("seed", 42)))
    STAGES[stage](cfg, RunDirs(os.path.dirname(root),
                               os.path.basename(root)), args, group)
    native_io.flush()  # a rank's process ends without its atexit hooks


def record_runtime(dirs, device: str):
    """Set the precision policy and record it, the device and the compute
    dtype in the run manifest."""
    policy = gt.set_precision_policy()
    dirs.manifest(device=device,
                  compute_dtype=str(compute_dtype(device)).split(".")[-1],
                  precision_policy=policy)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m gaussianip_tpu_torch.launch")
    parser.add_argument("--config", default="configs/exp.yaml")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--export", action="store_true",
                        help="the trained .ply -> a textured OBJ/MTL mesh")
    parser.add_argument("--cur_time", required=True)
    parser.add_argument("--stage", default=None,
                        help="override system.stage (stage1|stage2|stage3)")
    parser.add_argument("--stub-guidance", action="store_true",
                        help="weight-free run (tiny random diffusion stack, "
                             "synthetic SMPL-X body)")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume stage 1 from the run dir's latest "
                             "TrainState checkpoint")
    parser.add_argument("--resume_from", default=None,
                        help="explicit TrainState checkpoint path (implies "
                             "--resume)")
    parser.add_argument("--devices", default="auto",
                        help="data-parallel ranks: auto (every visible card; "
                             "1 with --device cpu), 1, or N (one card a "
                             "rank; --device cpu: N gloo ranks)")
    parser.add_argument("--recipe_batch", action="store_true",
                        help="keep the configured batch and cap the ranks "
                             "to its largest divisor, instead of rounding "
                             "the batch up to a multiple of the ranks")
    parser.add_argument("--gpu", default="0")  # accepted for CLI parity
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the port runs (cuda: the card, and an "
                             "error without one)")
    return parser.parse_known_args(argv)


def main(argv=None):
    from .utils.config import load_config
    from .utils.saving import RunDirs

    args, extras = parse_args(argv)
    _check_args(args)
    cfg = load_config(args.config, *extras)
    stage = args.stage or cfg["system"].get("stage", "stage1")
    dirs = RunDirs(cfg["system"].get("log_path", "logs"), args.cur_time)
    dirs.manifest(config=args.config, stage_requested=stage,
                  prompt=cfg["system"]["prompt_processor"]["prompt"])
    dirs.snapshot_code()
    record_runtime(dirs, args.device)

    np.random.seed(int(cfg.get("seed", 42)))

    if args.export:
        run_export(cfg, dirs, args)
    else:
        run(stage, cfg, dirs, args)


if __name__ == "__main__":
    main(sys.argv[1:])
