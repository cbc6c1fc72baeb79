"""One forward render of a saved avatar .ply to a PNG (port of
scripts/render_ply.py):

  python -m gaussianip_tpu_torch.render_ply --ply logs/<id>/save/last.ply \
      --azimuth 30 --elevation 5 --radius 1.8 --size 512 --out render.png

The camera sits on the orbit at (--elevation, --azimuth) degrees and
--radius, looks at the origin with +z up and has a vertical field of view
of --fovy degrees, at --size^2. The render is the default RenderConfig's
(the tiles backend: K1 on the card, its plain version with --device cpu);
the JAX script on the CPU takes the dense reference instead, which differs
by circle culling and the transmittance stop (a few 8-bit levels at most).
The default device, cuda, raises without a card.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ply", required=True)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=5.0)
    p.add_argument("--radius", type=float, default=1.8)
    p.add_argument("--fovy", type=float, default=70.0)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="render.png")
    p.add_argument("--bg", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def orbit_camera(azimuth: float, elevation: float, radius: float,
                 fovy: float, size: int, device):
    """The one camera [1] of the command line (angles in degrees)."""
    import math

    import torch

    from .data.cameras import camera_from_c2w
    from .ops.camera_math import deg2rad, look_at_c2w, spherical_to_position

    f32 = dict(dtype=torch.float32, device=device)
    eye = spherical_to_position(deg2rad(torch.tensor([elevation], **f32)),
                                deg2rad(torch.tensor([azimuth], **f32)),
                                torch.tensor([radius], **f32))
    c2w = look_at_c2w(eye, torch.zeros((1, 3), **f32),
                      torch.tensor([[0.0, 0, 1]], **f32))
    return camera_from_c2w(c2w, torch.tensor([math.radians(fovy)], **f32),
                           size, size)


def main(argv=None):
    """Renders and writes the PNG; returns the RenderOutput."""
    import torch

    from .launch import _check_args
    from .model.ply import state_from_ply
    from .render.render import RenderConfig, render
    from .utils.saving import save_image

    args = parse_args(argv)
    _check_args(args)
    gs = state_from_ply(args.ply, device=args.device)
    print(f"loaded {gs.n_active} gaussians (sh degree "
          f"{gs.max_sh_degree}) from {args.ply}")
    cams = orbit_camera(args.azimuth, args.elevation, args.radius,
                        args.fovy, args.size, args.device)
    with torch.no_grad():
        out = render(gs, cams, torch.tensor(args.bg, device=args.device),
                     RenderConfig())
    save_image(args.out, out.rgb[0].cpu().numpy())
    print(f"wrote {args.out} (alpha coverage "
          f"{float(out.alpha.mean()):.3f})")
    return out


if __name__ == "__main__":
    main()
