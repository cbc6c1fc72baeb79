"""Quality evaluation of a finished run directory (port of
scripts/eval_avatar.py):

  python -m gaussianip_tpu_torch.eval_avatar --run logs/<cur_time> \
      [--config configs/exp.yaml] [--face face.png] \
      [--lpips-vgg vgg16.pth --lpips-lin lpips_vgg.pth] [--device cuda]

Writes <run>/EVAL.json with the JAX script's keys:
  * psnr / ssim / l1 of the final avatar's 32 refine-orbit renders against
    the stage-2 refined targets, through the stage-3 loss's crop
    [60:890, 220:800] and x0.5 (the window scaled at smaller sizes);
  * lpips_vgg through system/pipeline.py:load_lpips when both checkpoints
    are given (else null and a note: a random LPIPS is no metric);
  * id_similarity: the cosine of the ArcFace embeddings of the input face
    and of a frontal head-orbit render (insightface; without it the face
    identity's fallback, reported as "fallback": its number is comparable
    to nothing).
The renders go through K1 on the card (`--device cuda`, the default).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def face_similarity(face_path: str, render_rgb: np.ndarray, scratch: str):
    """Cosine similarity of the ArcFace embeddings of the face photo and a
    rendered view [H, W, 3] in [0, 1] -> (similarity or None, backend).
    The fallback writes the render to `scratch` (a PNG path) to embed it."""
    try:
        import cv2
        from insightface.app import FaceAnalysis

        app = FaceAnalysis(name="buffalo_l",
                           providers=["CPUExecutionProvider"])
        app.prepare(ctx_id=0, det_size=(640, 640))
        ref = app.get(cv2.imread(face_path))
        img = (np.clip(render_rgb, 0, 1) * 255).astype(np.uint8)[..., ::-1]
        got = app.get(img)
        if not ref or not got:
            return None, "insightface (no face detected)"
        return float(np.dot(ref[0].normed_embedding,
                            got[0].normed_embedding)), "insightface"
    except ImportError:
        from .system.pipeline import face_identity
        from .utils.saving import save_image

        (e_ref, _), _ = face_identity(face_path, face_path)
        save_image(scratch, render_rgb)
        (e_r, _), _ = face_identity(scratch, scratch)
        return float(np.dot(e_ref[0], e_r[0])), "fallback"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gaussianip_tpu_torch."
                                      "eval_avatar")
    ap.add_argument("--run", required=True, help="run dir (logs/<cur_time>)")
    ap.add_argument("--config", default="configs/exp.yaml")
    ap.add_argument("--face", default=None,
                    help="input face photo (default: the config's "
                         "pil_image_faceid_path)")
    ap.add_argument("--lpips-vgg", default=None)
    ap.add_argument("--lpips-lin", default=None)
    ap.add_argument("--platform", default=None,
                    help="accepted for parity with scripts/eval_avatar.py; "
                         "--device chooses where the port runs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    import torch

    from .data.cameras import camera_from_c2w
    from .data.sampler import (CameraSamplerConfig, eval_orbit_batch,
                               refine_orbit_batch)
    from .model.ply import state_from_ply
    from .ops.resize import linear_resize
    from .render.render import RenderConfig, render
    from .system.refine import crop_and_downsample
    from .utils.config import load_config
    from .utils.metrics import l1, psnr, ssim

    args = parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    cfg = load_config(args.config)
    sys_cfg = cfg["system"]

    manifest_path = os.path.join(args.run, "run.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    ply = manifest.get("final_ply") or os.path.join(args.run, "save",
                                                    "last.ply")
    if not os.path.exists(ply):
        raise SystemExit(f"no final avatar at {ply}; run stage 3 first")
    refined_path = os.path.join(args.run, "after_refine.npz")
    if not os.path.exists(refined_path):
        raise SystemExit(f"no refined targets at {refined_path}")

    gs = state_from_ply(ply, device=dev)
    with np.load(refined_path) as data:
        refined = torch.as_tensor(data["refined_rgbs_small"], device=dev)
    n_views = refined.shape[0]

    H = int(sys_cfg.get("ori_height", 1024))
    if refined.shape[1] * 2 < 512:  # a smoke-scale run
        H = max(refined.shape[1] * 2, 32)
    orbit = refine_orbit_batch(
        n_views, float(sys_cfg["refine_elevation"]),
        float(sys_cfg["refine_camera_distance"]),
        float(sys_cfg["refine_fovy_deg"]), H, H, dev)
    rcfg = RenderConfig()
    bg = torch.zeros(3, device=dev)
    resize = lambda x, h, w: linear_resize(x.permute(0, 3, 1, 2), h,
                                           w).permute(0, 2, 3, 1)
    with torch.no_grad():
        rendered = torch.cat([render(gs, camera_from_c2w(
            orbit.c2w[i:i + 4], orbit.fovy[i:i + 4], H, H), bg, rcfg).rgb
            for i in range(0, n_views, 4)])
        if H == 1024:
            small = crop_and_downsample(rendered)
        else:
            # smoke scale: the window scaled as launch.run_stage3 scales it
            cy = (60 * H // 1024, max(890 * H // 1024, 60 * H // 1024 + 8))
            cx = (220 * H // 1024, max(800 * H // 1024, 220 * H // 1024 + 8))
            small = resize(rendered[:, cy[0]:cy[1], cx[0]:cx[1], :],
                           refined.shape[1], refined.shape[2])
        if small.shape != refined.shape:
            small = resize(small, refined.shape[1], refined.shape[2])
        x, y = small, refined
        out = {
            "n_views": int(n_views),
            "render_size": int(H),
            "psnr": float(torch.stack([psnr(a, b)
                                       for a, b in zip(x, y)]).mean()),
            "ssim": float(ssim(x, y)),
            "l1": float(l1(x, y)),
            "ply": ply,
        }

        # LPIPS only with the real checkpoints
        if args.lpips_vgg and args.lpips_lin:
            from .system.pipeline import load_lpips

            fn = load_lpips({"lpips_vgg_path": args.lpips_vgg,
                             "lpips_lin_path": args.lpips_lin}, dev)
            if fn is not None:
                out["lpips_vgg"] = float(np.mean(
                    [float(fn(x[i:i + 4], y[i:i + 4]).mean())
                     for i in range(0, n_views, 4)]))
        else:
            out["lpips_vgg"] = None
            out["lpips_note"] = ("pass --lpips-vgg/--lpips-lin for the "
                                 "perceptual metric")

        face = args.face or sys_cfg.get("guidance", {}).get(
            "pil_image_faceid_path")
        if face and os.path.exists(face):
            # the frontal view of the eval orbit's head half (azimuth +90)
            ecfg = CameraSamplerConfig(
                eval_height=H, eval_width=H, n_val_views=4,
                eval_elevation_deg=float(cfg["data"]["eval_elevation_deg"]),
                eval_camera_distance=float(
                    cfg["data"]["eval_camera_distance"]),
                eval_camera_distance_head=float(
                    cfg["data"]["eval_camera_distance_head"]),
                eval_fovy_deg=float(cfg["data"]["eval_fovy_deg"]))
            eo = eval_orbit_batch(ecfg, "val", dev)
            i_front = 4 + 3
            frontal = render(gs, camera_from_c2w(
                eo.c2w[i_front:i_front + 1], eo.fovy[i_front:i_front + 1],
                H, H), bg, rcfg).rgb[0].cpu().numpy()
            sim, backend = face_similarity(
                face, frontal, os.path.join(args.run, "save",
                                            "eval_frontal.png"))
            out["id_similarity"] = sim
            out["id_similarity_backend"] = backend
        else:
            out["id_similarity"] = None
            out["id_similarity_backend"] = "no face image configured"

    with open(os.path.join(args.run, "EVAL.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
