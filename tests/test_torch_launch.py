"""The port's command line (gaussianip_tpu_torch/launch.py, refine.py) on
the CPU at tiny sizes, and the run files it shares with the JAX package.

`python -m gaussianip_tpu_torch.launch --device cpu --stub-guidance` runs
stage 1 (2 steps), a `--resume` of it (1 more step), stage 2 and stage 3
(2 steps), in the manner of tests/test_launch_e2e.py: 256 points,
capacity 1024, 32^2 renders, ori_height 32, stub_image_size 32, 2 test
views. Validation and a checkpoint fire every step. Then the run files
cross over: the port's checkpoint and .ply load in the JAX package to the
same arrays, and a run directory the JAX package wrote (a TrainState
checkpoint, its .ply, the manifest and before_refine.npz) goes on in the
port: stage 2 through the port's refine entry (gaussianip_tpu_torch/
refine.py, at stub_image_size 16, to keep the file short), stage 3, and a
stage-1 resume from the JAX checkpoint. The densify and prune steps lie
beyond these runs. The same four calls with `--devices 2` (2 gloo ranks on
the CPU) leave the same files in the same layouts. The file runs in
~110 s on one CPU worker.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PARAM_FIELDS

torch.set_num_threads(1)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "exp.yaml")
TINY = ["system.height=32", "system.width=32", "system.ori_height=32",
        "system.ori_width=32", "system.stub_image_size=32",
        "system.pts_num=256", "system.capacity=1024",
        "data.eval_height=32", "data.eval_width=32", "data.n_test_views=2",
        "trainer.log_every_n_steps=1", "trainer.val_check_interval=1",
        "trainer.ckpt_every_n_steps=1"]
N_VIEWS = 32
CAPACITY = 1024


def _cli(log_path, run_id, *args):
    from gaussianip_tpu_torch import launch

    launch.main(["--config", CONFIG, "--cur_time", run_id, "--stub-guidance",
                 "--device", "cpu", f"system.log_path={log_path}", *TINY,
                 *args])
    with open(os.path.join(log_path, run_id, "run.json")) as f:
        return json.load(f)


def _stages(log, run_id, *args):
    """Stages 1, 1 (resumed), 2 and 3 into <log>/<run_id>: the manifest
    after each call."""
    from gaussianip_tpu_torch.utils.checkpoint import LEAF_ORDER

    man = {"stage1": _cli(log, run_id, "--train", "--stage", "stage1",
                          "--max_steps", "2", *args)}
    ck = os.path.join(log, run_id, "ckpt", "stage1_latest.npz")
    with np.load(ck) as d:
        man["ckpt_step_before_resume"] = int(
            d[f"leaf_{LEAF_ORDER.index('step')}"])
    man["resume"] = _cli(log, run_id, "--train", "--stage", "stage1",
                         "--resume", "--max_steps", "3", *args)
    man["stage2"] = _cli(log, run_id, "--stage", "stage2", *args)
    man["stage3"] = _cli(log, run_id, "--train", "--stage", "stage3",
                         "--max_steps", "2", *args)
    return os.path.join(log, run_id), man


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's run directory after stages 1, 1 (resumed), 2 and 3, with
    the manifest after each call."""
    return _stages(str(tmp_path_factory.mktemp("logs")), "e2e")


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The same four calls with --devices 2: 2 gloo ranks on the CPU."""
    return _stages(str(tmp_path_factory.mktemp("dp_logs")), "e2e",
                   "--devices", "2")


def _jax_init_state(capacity=CAPACITY):
    from gaussianip_tpu.model.gaussians import create_from_pcd
    from gaussianip_tpu.system.stage1 import init_train_state

    pts = np.zeros((4, 3), np.float32)
    return init_train_state(create_from_pcd(
        pts, np.full((4, 3), 0.5, np.float32), capacity,
        np.full((4,), 0.01, np.float32)))


def _port_init_state(capacity=CAPACITY):
    from gaussianip_tpu_torch.model.gaussians import empty_state
    from gaussianip_tpu_torch.system.stage1 import init_train_state

    return init_train_state(empty_state(capacity, device="cpu"))


def _port_leaves(ts):
    from gaussianip_tpu_torch.utils.checkpoint import LEAF_ORDER, _get

    out = {}
    for k in LEAF_ORDER:
        v = _get(ts, k)
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _path_name(path) -> str:
    """A jax key path as the dotted name LEAF_ORDER uses."""
    return ".".join(str(getattr(p, "name", getattr(p, "key", p)))
                    for p in path)


def test_cli_manifest(run):
    root, man = run
    m = man["stage3"]
    assert m["stage1"] == "done" and m["stage2"] == "done"
    assert m["stage3"] == "done"
    assert m["stage_requested"] == "stage3"
    assert m["config"] == CONFIG
    assert m["device"] == "cpu" and m["compute_dtype"] == "float32"
    assert m["precision_policy"] == {"matmul_tf32": False,
                                     "cudnn_tf32": False}
    assert m["prompt"].startswith("Audrey Hepburn")
    assert m["ply"] == os.path.join(root, "it3.ply")
    assert m["final_ply"] == os.path.join(root, "save", "last.ply")
    for s in ("stage1", "stage3"):
        assert m[f"{s}_wall_s"] >= 0
    # launch.py's keys, and the port's device, dtype, policy and the video
    # path that save_video wrote (code_* only in a git checkout)
    assert set(m) - {"code_commit", "code_dirty"} == {
        "config", "stage_requested", "prompt", "device", "compute_dtype",
        "precision_policy", "stage1", "stage1_steps", "ply", "stage1_wall_s",
        "stage2", "stage3", "final_ply", "stage3_wall_s", "video"}


def test_cli_files_and_shapes(run):
    from gaussianip_tpu_torch.model.ply import state_from_ply
    from gaussianip_tpu_torch.utils import native_io
    from gaussianip_tpu_torch.utils.saving import read_png

    root, man = run
    native_io.flush()
    with np.load(os.path.join(root, "before_refine.npz")) as d:
        for k in ("images", "control_images"):
            a = d[k]
            assert a.shape == (N_VIEWS, 32, 32, 3) and a.dtype == np.float32
            assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
    with np.load(os.path.join(root, "after_refine.npz")) as d:
        small = d["refined_rgbs_small"]
    assert small.shape == (N_VIEWS, 32, 32, 3) and np.isfinite(small).all()
    for name in ("raw_rgb_0", "raw_rgb_31", "refined_rgb_0",
                 "refined_rgb_31", "it1-0_rgb", "it2-0_rgb"):
        assert read_png(os.path.join(root, "save", name + ".png")).shape \
            == (32, 32, 3)
    # stage 3 renders at 2 x the refined size; 2 test views x (body, head)
    assert read_png(os.path.join(root, "save", "test", "0.png")).shape \
        == (64, 64, 3)
    assert os.path.exists(man["stage3"]["video"])
    g = state_from_ply(man["stage3"]["final_ply"], device="cpu")
    assert g.n_active > 0 and torch.isfinite(g.xyz[:g.n_active]).all()
    assert os.path.getsize(os.path.join(root, "metrics.csv")) > 0


def test_cli_resume(run):
    """The first call checkpoints after step index 1 (state at step 2); the
    resumed call loads it, runs the one step left to --max_steps 3, and
    writes no checkpoint at its own start step."""
    from gaussianip_tpu_torch.utils.checkpoint import load_train_state_npz

    root, man = run
    assert man["stage1"]["stage1_steps"] == 2
    assert man["ckpt_step_before_resume"] == 2
    assert man["resume"]["stage1_steps"] == 3
    assert os.path.exists(os.path.join(root, "it3.ply"))
    ts = load_train_state_npz(os.path.join(root, "ckpt",
                                           "stage1_latest.npz"),
                              _port_init_state())
    assert ts.step == 2 and ts.opt.count == 2


def test_resume_seed_differs_per_step():
    from gaussianip_tpu_torch.system.stage1 import resume_seed

    seeds = {resume_seed(42, s) for s in range(1, 100)}
    assert len(seeds) == 99 and 42 not in seeds


def test_leaf_order_matches_jax():
    from gaussianip_tpu_torch.utils.checkpoint import LEAF_ORDER

    flat, _ = jax.tree_util.tree_flatten_with_path(_jax_init_state(64))
    assert tuple(_path_name(p) for p, _ in flat) == LEAF_ORDER


def test_port_checkpoint_loads_in_jax(run):
    from gaussianip_tpu.utils.checkpoint import load_train_state_npz as jload
    from gaussianip_tpu_torch.utils.checkpoint import load_train_state_npz

    root, _ = run
    path = os.path.join(root, "ckpt", "stage1_latest.npz")
    jts = jload(path, _jax_init_state())
    port = _port_leaves(load_train_state_npz(path, _port_init_state()))
    flat, _ = jax.tree_util.tree_flatten_with_path(jts)
    assert len(flat) == len(port)
    for p, leaf in flat:
        name = _path_name(p)
        np.testing.assert_array_equal(np.asarray(leaf), port[name], name)
        if name in ("gaussians.n_active", "opt.count", "step"):
            assert leaf.dtype == jnp.int32, name
    assert int(jts.step) == 2 and int(jts.gaussians.n_active) == 256


def test_port_ply_loads_in_jax(run):
    from gaussianip_tpu.model.ply import state_from_ply as jfrom
    from gaussianip_tpu_torch.model.ply import state_from_ply

    _, man = run
    for key in ("ply", "final_ply"):
        path = man["stage3"][key]
        js, ps = jfrom(path), state_from_ply(path, device="cpu")
        assert int(js.n_active) == ps.n_active
        for f in PARAM_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ps, f).numpy(), f)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory written by the JAX package after stage 1: the
    TrainState checkpoint (step 1, random moments and stats), the .ply,
    the manifest and before_refine.npz."""
    from gaussianip_tpu.model.ply import state_to_ply
    from gaussianip_tpu.utils.checkpoint import save_train_state_npz
    from gaussianip_tpu.utils.saving import RunDirs

    rng = np.random.default_rng(3)
    log = str(tmp_path_factory.mktemp("jax_logs"))
    dirs = RunDirs(log, "jax")
    ts = _jax_init_state()
    g = ts.gaussians
    n = 200
    rand = lambda a, s=1.0: jnp.asarray(
        (rng.normal(size=a.shape) * s).astype(np.float32))
    g = g.replace(
        xyz=g.xyz.at[:n].set(rand(g.xyz[:n], 0.3)),
        f_dc=g.f_dc.at[:n].set(rand(g.f_dc[:n])),
        opacity=g.opacity.at[:n].set(rand(g.opacity[:n])),
        scaling=g.scaling.at[:n].set(rand(g.scaling[:n], 0.2) - 4.0),
        rotation=g.rotation.at[:n].set(rand(g.rotation[:n])),
        n_active=jnp.int32(n))
    opt = ts.opt.replace(
        m={k: rand(v, 1e-3) for k, v in ts.opt.m.items()},
        v={k: jnp.abs(rand(v, 1e-6)) for k, v in ts.opt.v.items()},
        count=jnp.int32(1))
    stats = ts.stats.replace(denom=jnp.abs(rand(ts.stats.denom)))
    ts = ts._replace(gaussians=g, opt=opt, stats=stats, step=jnp.int32(1))
    ckpt = save_train_state_npz(dirs.path("ckpt", "stage1_latest.npz"), ts)
    ply = dirs.path("it1.ply")
    state_to_ply(g, ply)
    images = rng.uniform(0, 1, (N_VIEWS, 32, 32, 3)).astype(np.float32)
    np.savez(dirs.path("before_refine.npz"), images=images,
             control_images=images[::-1].copy())
    dirs.manifest(config=CONFIG, stage_requested="stage1", prompt="p",
                  stage1="done", stage1_steps=1, ply=ply)
    return log, dirs, ts, ckpt


def test_jax_checkpoint_loads_in_port(jax_run):
    from gaussianip_tpu_torch.utils.checkpoint import load_train_state_npz

    _, _, jts, ckpt = jax_run
    port = _port_leaves(load_train_state_npz(ckpt, _port_init_state()))
    for p, leaf in jax.tree_util.tree_flatten_with_path(jts)[0]:
        np.testing.assert_array_equal(port[_path_name(p)], np.asarray(leaf),
                                      _path_name(p))


def test_jax_run_continues_in_port(jax_run):
    """Stage 2 (the port's refine entry) on the JAX before_refine.npz, stage
    3 on the JAX .ply named by the JAX manifest, then a stage-1 resume
    from the JAX checkpoint in a new run directory."""
    from gaussianip_tpu.model.ply import state_from_ply as jfrom
    from gaussianip_tpu_torch import refine
    from gaussianip_tpu_torch.model.ply import state_from_ply

    log, dirs, _, ckpt = jax_run
    # the port reads the JAX .ply to the JAX package's arrays
    js, ps = jfrom(dirs.manifest_get("ply")), state_from_ply(
        dirs.manifest_get("ply"), device="cpu")
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ps, f).numpy(), f)
    refine.main(["--config_path", CONFIG, "--log_path", log, "--cur_time",
                 "jax", "--stub-guidance", "--device", "cpu", *TINY,
                 "system.stub_image_size=16"])
    with np.load(dirs.path("after_refine.npz")) as d:
        assert d["refined_rgbs_small"].shape == (N_VIEWS, 16, 16, 3)
    m = _cli(log, "jax", "--train", "--stage", "stage3", "--max_steps", "2",
             "system.stub_image_size=16")
    assert m["stage3"] == "done" and m["ply"] == dirs.manifest_get("ply")
    g = state_from_ply(m["final_ply"], device="cpu")
    assert g.n_active > 0 and torch.isfinite(g.xyz[:g.n_active]).all()
    m = _cli(log, "resumed", "--train", "--stage", "stage1", "--resume_from",
             ckpt, "--max_steps", "2")
    assert m["stage1_steps"] == 2


@pytest.mark.parametrize("args,error", [
    (["--device", "cuda", "--stub-guidance", "--devices", "2"],
     r"--devices 2: 1 CUDA device\(s\) visible"),
    (["--stub-guidance"], "no CUDA device"),
])
def test_cli_refuses(tmp_path, monkeypatch, args, error):
    """Each refusal raises before the run directory exists: more ranks
    than visible cards (one card a rank; with 1 visible), and the card
    when there is none."""
    from gaussianip_tpu_torch import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=error):
        launch.main(["--config", CONFIG, "--cur_time", "x",
                     f"system.log_path={tmp_path}", *args])
    assert not os.path.exists(tmp_path / "x")


def _files(root):
    """Every file under root, a tensorboard event file's name without its
    time stamp and host."""
    names = (os.path.relpath(os.path.join(d, f), root)
             for d, _, fs in os.walk(root) for f in fs)
    return sorted(n.split(".tfevents.")[0] for n in names)


def test_cli_data_parallel_same_files(run, dp_run):
    """`--devices 2` on the CPU through stages 1 (and its resume), 2 and 3:
    the run directory holds the files of the 1-rank run, the arrays in the
    same layouts, the manifest the same keys and world_size 2, the stage-1
    steps resumed as there."""
    from gaussianip_tpu_torch.model.ply import state_from_ply
    from gaussianip_tpu_torch.utils import native_io

    native_io.flush()
    (root, man), (dp_root, dp_man) = run, dp_run
    assert _files(dp_root) == _files(root)
    for name in ("before_refine.npz", "after_refine.npz",
                 os.path.join("ckpt", "stage1_latest.npz")):
        with np.load(os.path.join(root, name)) as a, \
                np.load(os.path.join(dp_root, name)) as b:
            assert {k: (a[k].shape, a[k].dtype) for k in a.files} == {
                k: (b[k].shape, b[k].dtype) for k in b.files}, name
            assert all(np.isfinite(b[k]).all() for k in b.files
                       if b[k].dtype.kind == "f"), name
    m = dp_man["stage3"]
    assert m.pop("world_size") == 2
    assert set(m) == set(man["stage3"])
    assert dp_man["ckpt_step_before_resume"] == 2
    assert dp_man["resume"]["stage1_steps"] == 3
    with open(os.path.join(root, "metrics.csv")) as a, \
            open(os.path.join(dp_root, "metrics.csv")) as b:
        assert a.readline() == b.readline()
    g = state_from_ply(m["final_ply"], device="cpu")
    assert g.n_active > 0 and torch.isfinite(g.xyz[:g.n_active]).all()


@pytest.mark.parametrize("devices,recipe,world,batch", [
    ("3", False, 3, 6),  # the batch of 4 rounds up to 6
    ("3", True, 2, 4),  # the ranks fall to 2, the batch stays 4
    ("4", True, 4, 4),
    ("1", False, 1, 4),
    ("auto", False, 1, 4),  # auto on the CPU: one process
])
def test_world_size_and_batch_policy(devices, recipe, world, batch):
    """launch.py's batch-vs-mesh policy for a configured batch of 4:
    without --recipe_batch the batch rounds up to a multiple of the ranks,
    with it the ranks fall to the batch's largest divisor."""
    from gaussianip_tpu_torch import launch

    args, _ = launch.parse_args(["--cur_time", "x", "--device", "cpu",
                                 "--devices", devices]
                                + ["--recipe_batch"] * recipe)
    n = launch.resolve_world(args, 4)
    assert (n, launch.scale_batch(4, n)) == (world, batch)


def test_cli_export(run):
    """`--export` on the run directory after stage 3: the manifest's
    final_ply becomes export/model.{obj,mtl} and model_albedo.png, and the
    manifest records the paths."""
    root, man = run
    log, run_id = os.path.dirname(root), os.path.basename(root)
    m = _cli(log, run_id, "--export", "system.exporter.resolution=32",
             "system.exporter.density_thresh=0.05",
             "system.exporter.texture_size=64")
    exp = m["export"]
    assert exp == {k: os.path.join(root, "export", f"model{suffix}")
                   for k, suffix in (("obj", ".obj"), ("mtl", ".mtl"),
                                     ("texture", "_albedo.png"))}
    assert all(os.path.getsize(p) > 0 for p in exp.values())
    assert m["final_ply"] == man["stage3"]["final_ply"]


def test_cli_without_stub_needs_checkpoints(tmp_path):
    """Without --stub-guidance stage 1 loads the configured checkpoints;
    where they are absent (configs/exp.yaml's pretrained/ paths) it raises
    FileNotFoundError naming the directory and --stub-guidance."""
    from gaussianip_tpu_torch import launch

    with pytest.raises(FileNotFoundError, match="Realistic_Vision.*"
                       "--stub-guidance"):
        launch.main(["--config", CONFIG, "--cur_time", "x", "--device",
                     "cpu", f"system.log_path={tmp_path}", *TINY, "--train",
                     "--stage", "stage1", "--max_steps", "1"])


def test_refine_entry_refuses_without_stub(tmp_path):
    """The refine entry without --stub-guidance loads the checkpoints and
    raises FileNotFoundError, naming --stub-guidance, where they are
    absent."""
    from gaussianip_tpu_torch import refine

    os.makedirs(tmp_path / "x")
    img = np.zeros((N_VIEWS, 16, 16, 3), np.float32)
    np.savez(tmp_path / "x" / "before_refine.npz", images=img,
             control_images=img)
    with pytest.raises(FileNotFoundError, match="--stub-guidance"):
        refine.main(["--config_path", CONFIG, "--log_path", str(tmp_path),
                     "--cur_time", "x", "--device", "cpu"])
