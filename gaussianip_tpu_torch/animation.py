"""The port's animation command line (port of the repository's
animation.py), argument-compatible with it:

  python -m gaussianip_tpu_torch.animation --ply logs/<id>/save/last.ply \
      --motion content/amass_test_17.npz --smplx_path pretrained/smplx \
      --play --rotate --save videos [--device cpu]

Binds the trained splat avatar to the SMPL-X surface, re-poses it per
motion frame, renders a rotating orbit and writes
<save>/<ply stem>_<motion stem>.mp4 at 30 fps (or the frames as a .npy
stack beside it when no video writer is present). `--stub-body`, or a
missing SMPL-X model, takes the synthetic body. It runs on the card
(`--device cuda`, the default; it raises when there is none) or on the
CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import gaussianip_tpu_torch as gt


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ply", type=str, required=True)
    parser.add_argument("--motion", type=str, required=True)
    parser.add_argument("--smplx_path", type=str, default="pretrained/smplx")
    parser.add_argument("--save", type=str, default="videos")
    parser.add_argument("--rotate", action="store_true")
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--W", type=int, default=1024)
    parser.add_argument("--H", type=int, default=1024)
    parser.add_argument("--radius", type=float, default=2.5)
    parser.add_argument("--fovy", type=float, default=50)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--stub-body", action="store_true",
                        help="synthetic SMPL-X (no model files)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Runs the command line; returns the path of the video written."""
    opt = parse_args(argv)
    from .launch import _check_args

    _check_args(opt)
    from .human.animation import AvatarAnimator, load_animation_ply
    from .human.smplx import load_smplx_npz, make_test_model

    gs = load_animation_ply(opt.ply, device=opt.device)
    gt.info(f"loaded {gs.n_active} gaussians from {opt.ply}")

    if opt.stub_body or not (
        os.path.exists(opt.smplx_path)
        or os.path.exists(os.path.join(opt.smplx_path, "SMPLX_NEUTRAL.npz"))
    ):
        if not opt.stub_body:
            gt.warn(f"SMPL-X not found at {opt.smplx_path}; using synthetic "
                    f"body")
        params = make_test_model(np.random.default_rng(0), n_verts=2000,
                                 n_faces=3000, device=opt.device)
    else:
        params = load_smplx_npz(opt.smplx_path, device=opt.device)

    anim = AvatarAnimator(gs, params, motion_path=opt.motion)
    culled = anim.bind(0)
    gt.info(f"bound to mesh; culled {culled} gaussians (recon err > 0.01)")

    name = (os.path.splitext(os.path.basename(opt.ply))[0] + "_"
            + os.path.splitext(os.path.basename(opt.motion))[0])
    out = os.path.join(opt.save, f"{name}.mp4")
    anim.render_motion(out, play=opt.play, rotate=opt.rotate, height=opt.H,
                       width=opt.W, max_frames=opt.max_frames)
    gt.info(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
