"""The port's utilities, registry and CLI repairs against the JAX package on
the same inputs: the config loader and its YAML reader (against PyYAML),
save_config, C() schedules, the PNG writer and reader (against PIL and the
native writer), save_video, psnr / ssim / l1, the metrics CSV, Counters /
StageTimer / trace, the component registry, the SMPL-X npz loader and
Skeleton on a synthetic file in the official layout; then the same loaders
and writers with PyYAML, PIL, OpenCV and imageio unavailable (the port
runs without any of them), the stub stack's refusal of float32 on a CUDA
device, and the precision policy.

Tolerances: configs, schedules, PNG pixels, CSV rows and the SMPL-X
parameters are equal; psnr / ssim / l1 within 1e-5; the skeleton's
vertices and keypoints within 1e-5 (both float32).
"""

import io
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import n, t

torch.set_num_threads(1)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "exp.yaml")
OVERRIDES = [
    ["trainer.max_steps=100", "system.max_grad=1.0e-15",
     "system.optimizer.args.eps=1e-3", "system.bg_white=true",
     "system.apose=off", "system.smplx_path=null", "data.n_test_views=~",
     "system.guidance.grad_clip=[0, 2.0, 0.5, 300]",
     "system.prompt_processor.prompt=A tall man, in a suit"],
    ["tag=${rmspace:${system.prompt_processor.prompt},-}",
     "system.new.key=${data.batch_size}", "seed=0x1F", "system.height=017",
     "system.width=1_024", "system.lambda_l1=.5", "system.note='quoted # x'",
     "system.list=[a b, 'c', [1, 2.5e+3]]", "system.map={k: v, n: 1}",
     "system.neg=-.inf"],
]
SCALARS = ["1", "-7", "1.5", "1.0e-15", "1e-3", "1.0e5", "6.02e+23", "3.",
           ".5", "0x1F", "017", "0b101", "1_000", "1:30", "1:30.5", "+12",
           "true", "False", "yes", "NO", "on", "Off", "y", "null", "Null",
           "~", "", ".inf", "-.Inf", "2024-01-01", "abc", "a b c",
           "a # comment", "a#b", "'quoted'", '"dq\\tx"', "'it''s'",
           "[1, 2, x]", "[]", "{}", "{a: 1}", "[1, [2, [3]]]", "a: b",
           "a: b: c", "- x", "@x", "%x", "[1, 2", "=", "http://x.y/z",
           "value:with:colons", "-", "-x", "  padded  "]
BLOCK_SEQUENCES = ("- x", "-")


def _norm(v):
    """Comparable form (nan != nan)."""
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def test_yaml_reader_matches_pyyaml_on_config():
    from gaussianip_tpu_torch.utils import yamlio

    text = open(CONFIG).read()
    assert yamlio.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n- 1\n- 2", "a: |\n  x", "a: &x 1\nb: *x", "a: !!str 1",
    "---\na: 1", "a: [1,\n  2]", "a: 'x\n  y'", 'a: "\\x41"', "? a\n: b"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """Valid YAML outside the configs' constructs is refused, not read
    differently from PyYAML."""
    from gaussianip_tpu_torch.utils import yamlio

    yaml.safe_load(text)
    with pytest.raises(yamlio.Unsupported):
        yamlio.load(text)


@pytest.mark.parametrize("s", SCALARS)
def test_override_scalar_matches_jax(s):
    """The override parser resolves as the JAX one (yaml.safe_load, the
    raw string when PyYAML refuses); a block sequence, which the port's
    reader does not read, is refused rather than kept as a string."""
    from gaussianip_tpu.utils.config import _parse_scalar as jparse
    from gaussianip_tpu_torch.utils.config import _parse_scalar

    if s in BLOCK_SEQUENCES:
        assert isinstance(jparse(s), list)
        with pytest.raises(NotImplementedError, match="block sequences"):
            _parse_scalar(s)
        return
    got, ref = _parse_scalar(s), jparse(s)
    assert _norm(got) == _norm(ref) and type(got) is type(ref), (got, ref)


@pytest.mark.parametrize("overrides", [[]] + OVERRIDES,
                         ids=["none", "scalars", "interpolation"])
def test_load_config_matches_jax(overrides):
    from gaussianip_tpu.utils.config import load_config as jload
    from gaussianip_tpu_torch.utils.config import load_config

    got, ref = load_config(CONFIG, *overrides), jload(CONFIG, *overrides)
    assert _norm(got) == _norm(ref)


def test_load_config_types():
    from gaussianip_tpu_torch.utils.config import load_config

    c = load_config(CONFIG, *OVERRIDES[0])
    assert c["system"]["max_grad"] == 1e-15
    assert c["system"]["optimizer"]["args"]["eps"] == "1e-3"
    assert c["system"]["optimizer"]["args"]["lr"] == 0.001
    assert c["system"]["bg_white"] is True and c["system"]["apose"] is False
    assert c["system"]["smplx_path"] is None
    assert c["system"]["guidance"]["grad_clip"] == [0, 2.0, 0.5, 300]
    assert c["tag"] == "A_tall_man,_in_a_suit"
    assert c["checkpoint"]["every_n_train_steps"] == 100
    c = load_config(CONFIG, *OVERRIDES[1])
    assert c["tag"] == c["system"]["prompt_processor"]["prompt"].replace(
        " ", "-")
    assert c["system"]["new"]["key"] == 4 and c["seed"] == 31


def test_save_config_round_trip(tmp_path):
    from gaussianip_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(CONFIG, *OVERRIDES[0])
    cfg["extra"] = {"nested": [{"a": 1, "b": [1.5, None]}, [True, "x: y"]],
                    "text": "line\nbreak", "empty": {}, "none": [],
                    "tiny": 1e-5, "big": 1e16, "str_num": "1.5"}
    p = str(tmp_path / "cfg.yaml")
    save_config(cfg, p)
    text = open(p).read()
    assert yaml.safe_load(text) == cfg
    assert load_config(p) == cfg


@pytest.mark.parametrize("value", [
    0.5, 3, [100, 0.0, 1.0, 300], [0, 1.5, 2.0, 1000], [1.5, 2.0, 1000],
    [10, 1.0, 0.0, 20.0]])
def test_schedule_matches_jax(value):
    from gaussianip_tpu.utils.config import C as jC
    from gaussianip_tpu_torch.utils.config import C

    for step in (0, 5, 10, 15, 100, 150, 299, 300, 999, 1000, 5000):
        assert C(value, step) == jC(value, step), (value, step)


def test_png_decodes_bit_for_bit_through_pil(tmp_path, rng):
    from PIL import Image

    from gaussianip_tpu.utils.saving import save_image as jsave
    from gaussianip_tpu_torch.utils.saving import read_png, save_image

    u8 = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    f32 = rng.uniform(-0.2, 1.2, (19, 23, 3)).astype(np.float32)
    for name, img in (("u8", u8), ("f32", f32)):
        p = save_image(str(tmp_path / f"{name}.png"), img)
        got = np.asarray(Image.open(p).convert("RGB"))
        jp = jsave(str(tmp_path / f"{name}_jax.png"), img)
        np.testing.assert_array_equal(got, np.asarray(Image.open(jp)))
        np.testing.assert_array_equal(read_png(p), got)
        # the JAX package's PIL-written file through the port's reader
        np.testing.assert_array_equal(read_png(jp), got)


def test_png_reader_filters_and_modes(rng):
    from PIL import Image

    from gaussianip_tpu_torch.utils.saving import decode_png

    smooth = np.linspace(0, 255, 24 * 31 * 3).reshape(24, 31, 3)
    for img in (rng.integers(0, 256, (24, 31, 3)).astype(np.uint8),
                smooth.astype(np.uint8)):
        for mode in ("RGB", "RGBA", "L", "LA"):
            im = Image.fromarray(img).convert(mode)
            buf = io.BytesIO()
            im.save(buf, format="PNG", optimize=True)
            np.testing.assert_array_equal(decode_png(buf.getvalue()),
                                          np.asarray(im.convert("RGB")))


def test_native_png_through_port_reader(tmp_path, rng):
    from gaussianip_tpu_torch.utils import native_io
    from gaussianip_tpu_torch.utils.saving import read_png

    img = rng.integers(0, 256, (17, 29, 3)).astype(np.uint8)
    p = str(tmp_path / "n.png")
    if not native_io.write_png_async(p, img):
        pytest.skip("the native writer did not build here")
    native_io.flush()
    assert native_io.pending() == 0
    np.testing.assert_array_equal(read_png(p), img)


def test_save_video_and_sequence(tmp_path, rng):
    from gaussianip_tpu_torch.utils.saving import (save_image,
                                                   save_img_sequence_as_video,
                                                   save_video)

    frames = rng.uniform(0, 1, (5, 16, 16, 3)).astype(np.float32)
    out = save_video(str(tmp_path / "v.mp4"), frames, fps=30)
    assert os.path.getsize(out) > 0
    if out.endswith(".npy"):
        np.testing.assert_array_equal(
            np.load(out), (frames * 255).astype(np.uint8))
    for i, f in enumerate(frames):
        save_image(str(tmp_path / "seq" / f"{i * 2}.png"), f)
    out2 = save_img_sequence_as_video(str(tmp_path / "s.mp4"),
                                      str(tmp_path / "seq"))
    assert os.path.getsize(out2) > 0


def test_run_dirs_manifest(tmp_path):
    from gaussianip_tpu.utils.saving import RunDirs as JRunDirs
    from gaussianip_tpu_torch.utils.saving import RunDirs

    d = RunDirs(str(tmp_path), "r")
    d.manifest(a=1, b="x")
    d.manifest(b="y")
    assert d.manifest_get("b") == "y" and d.manifest_get("zz", 3) == 3
    # the JAX package reads and extends the same manifest
    j = JRunDirs(str(tmp_path), "r")
    assert j.manifest(c=[1, 2]) == {"a": 1, "b": "y", "c": [1, 2]}
    assert d.manifest_get("c") == [1, 2]
    assert d.path("x", "y.txt") == os.path.join(d.root, "x", "y.txt")


def test_image_metrics_match_jax(rng):
    from gaussianip_tpu.utils import metrics as jm
    from gaussianip_tpu_torch.utils import metrics as pm

    a = rng.uniform(0, 1, (2, 21, 17, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim", "l1"):
        got = float(getattr(pm, name)(t(a), t(b)))
        ref = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (name, got, ref)
    got = float(pm.ssim(t(a[0]), t(b[0])))
    ref = float(jm.ssim(jnp.asarray(a[0]), jnp.asarray(b[0])))
    assert abs(got - ref) <= 1e-5


def test_metrics_csv_matches_jax(tmp_path):
    from gaussianip_tpu.utils.logging import MetricsLogger as JLogger
    from gaussianip_tpu_torch.utils.logging import MetricsLogger

    rows = [(0, {"loss": 1.5, "n": 3}), (1, {"loss": t(np.float32(0.25)),
                                             "n": 4}),
            (2, {"loss": 0.1, "extra": 2.0, "n": 5, "skip": "text"})]
    out = []
    for cls, sub in ((MetricsLogger, "port"), (JLogger, "jax")):
        lg = cls(str(tmp_path / sub), use_tensorboard=False)
        for step, m in rows:
            lg.log(step, m)
        lg.close()
        out.append(open(tmp_path / sub / "metrics.csv").read())
    assert out[0] == out[1]


def test_counters_and_stage_timer(tmp_path):
    """As tests/test_aux.py:test_profiling_utils."""
    from gaussianip_tpu_torch.utils.profiling import Counters, StageTimer

    c = Counters()
    c.add("loss", 2.0)
    c.add("loss", 4.0)
    assert c.mean("loss") == 3.0
    out = c.dump(str(tmp_path / "c.json"))
    assert out["loss"]["n"] == 2
    manifest = {}
    timer = StageTimer(lambda **kw: manifest.update(kw))
    with timer.stage("s1"):
        pass
    assert "wall_s_s1" in manifest


def test_trace_writes_chrome_trace(tmp_path):
    from gaussianip_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_registry_resolves_config_types():
    import gaussianip_tpu_torch as gt
    import gaussianip_tpu_torch.components  # noqa: F401
    from gaussianip_tpu.components import RandomCameraDataModule as JDM
    from gaussianip_tpu_torch.guidance.prompts import (fake_text_encoder,
                                                       make_prompt_embeddings)
    from gaussianip_tpu_torch.model.gaussians import empty_state
    from gaussianip_tpu_torch.system.stage1 import init_train_state
    from gaussianip_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    names = [cfg["data_type"], cfg["system_type"],
             cfg["system"]["guidance_type"],
             cfg["system"]["prompt_processor_type"]]
    assert sorted(names) == sorted(gt.__modules__)
    for name in names:
        assert gt.find(name) is not None
    with pytest.raises(KeyError):
        gt.find("no-such-component")
    dm = gt.find("random-camera-datamodule")(cfg["data"], 512, 512)
    assert dm.cfg.__dict__ == {k: v for k, v in JDM(cfg["data"], 512,
                                                    512).cfg.__dict__.items()
                               if k in dm.cfg.__dict__}
    assert dm.sample_train(torch.Generator().manual_seed(0), 0,
                           "cpu").c2w.shape == (4, 4, 4)
    assert dm.eval_orbit("val", "cpu").c2w.shape == (16, 4, 4)
    ts = gt.find("gaussianip-system")(empty_state(8, device="cpu"))
    assert ts.step == 0 and ts.gaussians.capacity == 8
    assert type(ts) is type(init_train_state(ts.gaussians))
    pe = gt.find("ipa-prompt-processor")(fake_text_encoder(4, 8), "a", "b",
                                         "", device="cpu")
    assert type(pe) is type(make_prompt_embeddings(
        fake_text_encoder(4, 8), "a", "b", "", device="cpu"))


def _write_official_smplx(path, rng, n_verts=10475, n_faces=2000):
    """A synthetic SMPLX_NEUTRAL.npz in the official layout (every vertex
    id the keypoints pick exists: 10475 vertices, as the real model)."""
    parents = np.zeros(55, np.int64)
    parents[0] = -1
    parents[1:] = rng.integers(0, np.arange(1, 55))
    jr = rng.uniform(0, 1, (55, n_verts)).astype(np.float32)
    w = rng.uniform(0, 1, (n_verts, 55)).astype(np.float32) ** 4
    np.savez(path,
             v_template=rng.normal(0, 0.3, (n_verts, 3)).astype(np.float32),
             shapedirs=rng.normal(0, 0.01, (n_verts, 3, 400)
                                  ).astype(np.float32),
             posedirs=rng.normal(0, 0.001, (n_verts, 3, 486)
                                 ).astype(np.float32),
             J_regressor=jr / jr.sum(1, keepdims=True),
             kintree_table=np.stack([parents, np.arange(55)]),
             weights=w / w.sum(1, keepdims=True),
             f=rng.integers(0, n_verts, (n_faces, 3)).astype(np.uint32))


def test_smplx_npz_and_skeleton_match_jax(tmp_path, rng):
    from gaussianip_tpu.human.skeleton import Skeleton as JSkeleton
    from gaussianip_tpu.human.smplx_jax import load_smplx_npz as jload
    from gaussianip_tpu_torch.human.skeleton import Skeleton
    from gaussianip_tpu_torch.human.smplx import load_smplx_npz
    from gaussianip_tpu_torch.launch import build_skeleton

    _write_official_smplx(str(tmp_path / "SMPLX_NEUTRAL.npz"), rng)
    jp = jload(str(tmp_path))
    pp = load_smplx_npz(str(tmp_path), device="cpu")
    for f in jp._fields:
        np.testing.assert_array_equal(n(getattr(pp, f)),
                                      np.asarray(getattr(jp, f)), f)
    jsk = JSkeleton(str(tmp_path))
    sk = Skeleton(smplx_path=str(tmp_path), device="cpu")
    for s in (jsk, sk):
        s.forward_smplx()
        s.scale(-10)
    np.testing.assert_allclose(sk.vertices, jsk.vertices, atol=1e-5)
    np.testing.assert_allclose(sk.points3d, jsk.points3d, atol=1e-5)
    # the CLI takes the file when system.smplx_path names it
    sk2 = build_skeleton({"smplx_path": str(tmp_path)}, stub=False,
                         device="cpu")
    np.testing.assert_array_equal(sk2.points3d, sk.points3d)


def test_without_optional_packages(tmp_path, monkeypatch, rng):
    """Without PyYAML, PIL, OpenCV and imageio the config loader, the PNG
    writer and the video writer (its .npy stack) work."""
    for mod in ("yaml", "PIL", "PIL.Image", "cv2", "imageio"):
        monkeypatch.setitem(sys.modules, mod, None)
    from gaussianip_tpu_torch.utils.config import load_config, save_config
    from gaussianip_tpu_torch.utils.saving import (read_png, save_image,
                                                   save_video)

    cfg = load_config(CONFIG, "system.max_grad=1.0e-15")
    assert cfg["system"]["max_grad"] == 1e-15
    save_config(cfg, str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.yaml")) == cfg
    img = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    p = save_image(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(p), (img * 255).astype(np.uint8))
    frames = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    out = save_video(str(tmp_path / "v.mp4"), frames)
    assert out == str(tmp_path / "v.mp4") + ".npy"
    np.testing.assert_array_equal(np.load(out),
                                  (frames * 255).astype(np.uint8))


def test_stub_stack_refuses_float32_on_cuda():
    """Refused at build time, before any CUDA call (this host has no
    card): K3 takes bf16 only."""
    from gaussianip_tpu_torch.system.pipeline import build_stub_guidance_stack

    for dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="bfloat16"):
            build_stub_guidance_stack("p", "n", device="cuda", dtype=dtype)
    g = build_stub_guidance_stack("p", "n", image_size=16, device="cpu")
    assert next(g.models.unet.parameters()).device.type == "cpu"


def test_precision_policy(monkeypatch):
    import gaussianip_tpu_torch as gt

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert gt.set_precision_policy() == {"matmul_tf32": False,
                                         "cudnn_tf32": False}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_checkpoint_round_trip(tmp_path, rng):
    from gaussianip_tpu_torch.model.gaussians import empty_state
    from gaussianip_tpu_torch.system.stage1 import init_train_state
    from gaussianip_tpu_torch.utils.checkpoint import (LEAF_ORDER, _get,
                                                       load_train_state_npz,
                                                       save_train_state_npz)

    ts = init_train_state(empty_state(64, max_sh_degree=1, device="cpu"))
    for k in LEAF_ORDER:
        v = _get(ts, k)
        if isinstance(v, torch.Tensor):
            v.copy_(t(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    ts = ts._replace(step=7, opt=ts.opt.__class__(ts.opt.m, ts.opt.v, 5),
                     gaussians=ts.gaussians.replace(n_active=40))
    p = save_train_state_npz(str(tmp_path / "ck.npz"), ts)
    like = init_train_state(empty_state(64, max_sh_degree=1, device="cpu"))
    back = load_train_state_npz(p, like)
    for k in LEAF_ORDER:
        a, b = _get(ts, k), _get(back, k)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
        else:
            assert a == b, k
    assert back.gaussians.max_sh_degree == 1
    with pytest.raises(ValueError, match="shape"):
        load_train_state_npz(p, init_train_state(empty_state(
            32, max_sh_degree=1, device="cpu")))


def test_package_import_is_light():
    """Importing the package (the registry) imports neither torch nor a
    kernel wrapper."""
    import subprocess

    code = ("import sys, gaussianip_tpu_torch, gaussianip_tpu_torch.components;"
            " bad = [m for m in ('torch', 'gaussianip_tpu_torch.render."
            "composite_cuda', 'gaussianip_tpu_torch.ops.conv3x3_cuda') "
            "if m in sys.modules]; sys.exit(str(bad) if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr or r.stdout
