"""Standalone stage-2 VCR refinement entry (port of the repository's
refine.py):

  python -m gaussianip_tpu_torch.refine --config_path configs/exp.yaml \
      --log_path logs --cur_time <id> [--stub-guidance] [--device cpu]

A thin wrapper over launch's stage 2 (launch.run: one process, or
`--devices N` ranks as launch runs them), with launch's refusals; without
`--stub-guidance` it loads the checkpoints the config names."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from . import launch
    from .utils.config import load_config
    from .utils.saving import RunDirs

    parser = argparse.ArgumentParser(prog="python -m gaussianip_tpu_torch.refine")
    parser.add_argument("--config_path", default="configs/exp.yaml")
    parser.add_argument("--log_path", default="logs")
    parser.add_argument("--cur_time", required=True)
    parser.add_argument("--pil_image_path", default=None)
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--stub-guidance", action="store_true")
    parser.add_argument("--devices", default="auto",
                        help="data-parallel ranks, as launch's --devices")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args, extras = parser.parse_known_args(argv)
    launch._check_args(args)

    overrides = list(extras)
    if args.prompt:
        overrides.append(f"system.prompt_processor.prompt={args.prompt}")
    if args.pil_image_path:
        overrides.append(
            f"system.guidance.pil_image_faceid_path={args.pil_image_path}")
    overrides.append(f"system.log_path={args.log_path}")
    cfg = load_config(args.config_path, *overrides)
    dirs = RunDirs(args.log_path, args.cur_time)
    launch.record_runtime(dirs, args.device)
    launch.run("stage2", cfg, dirs, args)


if __name__ == "__main__":
    main(sys.argv[1:])
