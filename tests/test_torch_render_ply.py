"""The port's one-shot render of a .ply (python -m
gaussianip_tpu_torch.render_ply) against the JAX package's
scripts/render_ply.py, run as its user runs it on the CPU (a subprocess,
--cpu, JAX_PLATFORMS=cpu), on one .ply written by model/ply.py:save_ply
from seeded points (SH degree 1), at 64^2.

The JAX script on the CPU renders with the dense reference compositor
(backend "auto"); the port with the tiles path's plain version. The two
differ by circle culling and the 1e-4 transmittance stop, so the PNGs are
compared as 8-bit values: at least 99% within 1 level and none beyond 8.
The printed alpha coverage agrees within 1e-3.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
N = 600
WITHIN_1_SHARE = 0.99
MAX_LEVELS = 8
COVERAGE_TOL = 1e-3


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    from gaussianip_tpu_torch.model.ply import save_ply

    rng = np.random.default_rng(7)
    xyz = rng.normal(0, 0.25, (N, 3)).astype(np.float32)
    q = rng.normal(0, 1, (N, 4)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ply") / "avatar.ply")
    save_ply(path, xyz,
             rng.normal(0, 0.8, (N, 1, 3)).astype(np.float32),
             rng.normal(0, 0.2, (N, 3, 3)).astype(np.float32),
             rng.uniform(-2, 3, (N, 1)).astype(np.float32),
             np.log(rng.uniform(0.01, 0.05, (N, 3))).astype(np.float32),
             q / np.linalg.norm(q, axis=1, keepdims=True))
    return path


def _flags(ply, out, azimuth, bg):
    return ["--ply", ply, "--azimuth", str(azimuth), "--elevation", "10",
            "--size", str(SIZE), "--bg", *map(str, bg), "--out", out]


def _coverage(text: str) -> float:
    return float(text.split("alpha coverage ")[1].split(")")[0])


@pytest.mark.parametrize("azimuth,bg", [(0.0, (0.0, 0.0, 0.0)),
                                        (135.0, (0.2, 0.5, 0.9))])
def test_render_ply_matches_jax_script(ply, tmp_path, capsys, azimuth, bg):
    from gaussianip_tpu_torch import render_ply
    from gaussianip_tpu_torch.utils.saving import read_png

    jpng, tpng = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     "render_ply.py"),
                        *_flags(ply, jpng, azimuth, bg), "--cpu"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    render_ply.main([*_flags(ply, tpng, azimuth, bg), "--device", "cpu"])
    out = capsys.readouterr().out
    jlines, tlines = r.stdout.strip().splitlines(), out.strip().splitlines()
    assert len(tlines) == 2
    assert tlines[0] == jlines[0] == (f"loaded {N} gaussians (sh degree 1) "
                                      f"from {ply}")
    assert tlines[1].startswith(f"wrote {tpng} (alpha coverage ")
    assert abs(_coverage(tlines[1]) - _coverage(jlines[-1])) <= COVERAGE_TOL

    jimg, timg = read_png(jpng), read_png(tpng)
    assert jimg.shape == timg.shape == (SIZE, SIZE, 3)
    d = np.abs(jimg.astype(np.int16) - timg.astype(np.int16))
    assert (d <= 1).mean() >= WITHIN_1_SHARE, (d <= 1).mean()
    assert d.max() <= MAX_LEVELS, d.max()
    assert 0.05 < _coverage(tlines[1]) < 0.95  # the camera sees the ball


def test_render_ply_refuses_missing_card(ply, tmp_path):
    from gaussianip_tpu_torch import render_ply

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_ply.main(["--ply", ply, "--out", str(tmp_path / "x.png")])
