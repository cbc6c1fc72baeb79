"""CPU tests of the benchmark: every file it names loads, the JAX check,
the reference's independence from the port, the reference against the
port at tiny sizes, the analytic counts, and whole runs at tiny sizes with
the timed path sound and broken. The card's own runs are `benchmark/run.py`
(the cells) and `benchmark/control.py` (the limits' readings)."""

import argparse
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import compare, flops, run, stack
from benchmark.tests import tiny

ROOT = run.ROOT
HERE = run.HERE
BENCH = run.load_json(ROOT, "BENCHMARK.json")
SEED = 2 ** 33 + 5


def _run(workload, seed=SEED, trace=0, adjust=tiny.shrink):
    return run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", "0.5", "--trace", str(trace)],
                    device="cpu", adjust=adjust)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_cell_config_and_metric_loads_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert run.load_json(ROOT, c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        wl = run.load_json(HERE, "workloads", f"{w['name']}.json")
        assert wl["config"] == w["config"] in names
        assert wl["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(HERE, "entries",
                                           f"{wl['entry']}.py"))
        assert wl["limits"] and wl["control"] in ("fp8", "tf32")
        e2e = run.cell_metrics(BENCH, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.cell_metrics(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_cell_brings_its_test_files():
    """Each cell's tiny sizes and limits, its configuration's tiny widths
    and its entry's timed-path faults, as files found by name
    (benchmark/tests/tiny.py)."""
    missing = tiny.missing_files(CELLS)
    assert not missing, "missing test files: " + ", ".join(
        os.path.relpath(p, ROOT) for p in missing)


@pytest.mark.parametrize("how", ["cell not listed", "no test files"])
def test_a_cell_without_its_test_files_fails_naming_them(monkeypatch,
                                                         tmp_path, how):
    if how == "cell not listed":
        monkeypatch.setattr(sys.modules[__name__], "CELLS",
                            CELLS + ["stage1-unlisted-512"])
        want = ["benchmark/tests/cells/stage1-unlisted-512.json"]
    else:
        monkeypatch.setattr(tiny, "TESTS", str(tmp_path))
        want = ["cells/stage1-guided-512.json", "configs/gaussianip-sd15.json",
                "timed_faults/stage1_step.py"]
    assert tiny.fault_kinds("stage1-unlisted-512") == ()
    with pytest.raises(AssertionError) as err:
        test_every_cell_brings_its_test_files()
    for name in want:
        assert name in str(err.value), (name, str(err.value))


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    mods = dict(sys.modules)
    for m in ("gaussianip_tpu_torch", "gaussianip_tpu_torch.ops",
              "jaxtyping", "flaxen"):
        mods.setdefault(m, object())
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    for bad in ("gaussianip_tpu.render", "jaxlib", "jax", "flax.linen"):
        monkeypatch.setitem(sys.modules, bad, object())
    assert run.forbidden_modules() == ["flax", "gaussianip_tpu", "jax",
                                       "jaxlib"]


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for n in ast.walk(tree):
                if isinstance(n, ast.Import):
                    assert not any(a.name.split(".")[0].startswith(
                        ("gaussianip", "jax", "flax")) for a in n.names), f
                if isinstance(n, ast.ImportFrom) and n.level == 0:
                    assert not n.module.split(".")[0].startswith(
                        ("gaussianip", "jax", "flax", "benchmark")), f
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.stack as s; s.package(s.REFERENCE); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"gaussianip_tpu_torch", "gaussianip_tpu", "jax",
                         "jaxlib", "flax"}


def test_reference_agrees_with_the_port_at_tiny_sizes():
    """Both sides in float32 on the CPU: the port's plain kernels against
    the reference's copies, through three stage-1 steps."""
    from benchmark.entries import stage1_step

    cfg = run.load_json(HERE, "configs", "gaussianip-sd15.json")
    wl = run.load_json(HERE, "workloads", "stage1-guided-512.json")
    tiny.shrink(cfg, wl)
    got = [stage1_step._drive(root, cfg, wl["params"], SEED, "cpu",
                              torch.float32)[2]
           for root in (stack.PROGRAM, stack.REFERENCE)]
    g = compare.gaps(*got)
    assert g["change"] < 1e-4 and g["loss"] < 1e-6 and g["grad"] < 1e-6, g


def test_reference_stage3_and_refine_agree_with_the_port_at_tiny_sizes():
    """Stage 3's steps and the refine, both sides in float32 on the CPU:
    stage 3 runs the same arithmetic on both (exact); the refine differs
    by the port's 3x3 conv and fused attention alone."""
    from benchmark.entries import refine, stage3_step

    cfg = run.load_json(HERE, "configs", "gaussianip-recon.json")
    wl = run.load_json(HERE, "workloads", "stage3-recon-1024.json")
    tiny.shrink(cfg, wl)
    got = [stage3_step._drive(root, cfg, wl["params"], SEED, "cpu")[2]
           for root in (stack.PROGRAM, stack.REFERENCE)]
    assert max(compare.gaps(*got).values()) == 0.0
    cfg = run.load_json(HERE, "configs", "gaussianip-sd15.json")
    wl = run.load_json(HERE, "workloads", "stage2-vcr-1024.json")
    tiny.shrink(cfg, wl)
    views = []
    for root in (stack.PROGRAM, stack.REFERENCE):
        pkg, models, ins = refine._refine(root, cfg, wl["params"], SEED,
                                          "cpu", torch.float32)
        views.append(pkg.refine.refine_views(models, *ins,
                                             **refine._kwargs(wl["params"])))
    assert refine.rms(*views) < 1e-5


def test_counts_hold_against_the_flop_counter_on_real_tensors():
    """The meta-device counts equal FlopCounterMode's on real tensors of
    the reference's modules at tiny widths, and the K3 sites are the
    stride-1 3x3 convs: per resnet two, per upsampler one."""
    cfg = run.load_json(HERE, "configs", "gaussianip-sd15.json")
    tiny.shrink_config(cfg)
    got = flops.denoise_call(cfg, 2, 8)
    pkg, unet, cn, vae = flops._meta_models(cfg)
    gen = torch.Generator().manual_seed(0)
    from benchmark import inputs

    unet, cn, vae = (inputs.load(inputs.on_meta(lambda m=m: type(m)(
        m.cfg) if m is not cn else type(m)(
        m.cfg, conditioning_embed_channels=(8, 16))),
        {k: torch.randn(v.shape, generator=gen) * 0.05
         for k, v in m.state_dict().items()}) for m in (unet, cn, vae))
    lat = torch.randn(2, 4, 8, 8)
    ctx = torch.randn(2, 8 + 4, 32)
    t = torch.zeros(2, dtype=torch.int64)
    ctrl = torch.rand(2, 3, 16, 16)

    def call():
        with torch.no_grad():
            res, mid = cn(lat, t, ctx, ctrl)
            unet(lat, t, ctx, down_block_residuals=res,
                 mid_block_residual=mid)

    assert flops._counted(call) == got["flops"]
    levels, per = 2, 1  # the tiny UNet: 2 levels of 1 resnet
    unet_sites = (levels * per + 2 + levels * (per + 1)) * 2 + (levels - 1)
    assert got["k3_sites"] == unet_sites + (levels * per + 2) * 2
    x = torch.rand(2, 3, 16, 16, requires_grad=True)
    eps = torch.randn(2, 4, 8, 8)

    def enc():
        vae.encode(x, eps).sum().backward()

    assert flops._counted(enc) == flops.vae_encode(cfg, 2, 16, True)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    line = _run(cell)
    assert line["correct"] and line["failed"] == 0, line["compared"]
    assert set(line["metrics"]) == {
        m["name"] for m in run.cell_metrics(BENCH, cell, "end_to_end")}
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(run.load_json(
        HERE, "workloads", f"{cell}.json")["limits"])


def test_a_traced_run_reads_the_trace():
    line = _run("stage1-guided-512", trace=1)
    assert line["correct"]
    assert "mfu.stage1" in line["metrics"]
    assert "device_ops" in line["breakdown"]
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,kind", [(c, k) for c in CELLS
                                       for k in tiny.fault_kinds(c)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, kind):
    """The program's timed path broken underneath by the faults of the
    cell's entry (benchmark/tests/timed_faults/<entry>.py)."""
    tiny.timed_faults(cell).break_timed(monkeypatch, kind)
    line = _run(cell, seed=SEED + 1)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference one precision step below the configuration's, in the
    program's place, fails at least one limit (stage 3's control is TF32,
    which only the card has)."""
    import importlib

    wl = run.load_json(HERE, "workloads", f"{cell}.json")
    cfg = run.load_json(HERE, "configs", f"{wl['config']}.json")
    if wl["control"] == "tf32" and not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cpu":
        tiny.shrink(cfg, wl)
    entries = importlib.import_module(f"benchmark.entries.{wl['entry']}")
    ctx = argparse.Namespace(cfg=cfg, params=wl["params"], seed=SEED + 2,
                             device=dev)
    ref = entries.reference_readings(ctx)
    got = entries.reference_readings(ctx, quant=wl["control"])
    g = entries.gaps(got, ref)
    assert any(g[k] > lim for k, lim in wl["limits"].items()), g


def test_k12_bound_is_bench_pipelines_arithmetic():
    from gaussianip_tpu_torch import bench_pipeline as bp

    assert flops.K12_OPS_PER_PAIR == bp.OPS_PER_PAIR
    assert (flops.K2_EPILOGUE_OPS, flops.K12_BYTES_PER_INSTANCE,
            flops.K2_EPILOGUE_BYTES) == (bp.EPILOGUE_OPS,
                                         bp.BYTES_PER_INSTANCE,
                                         bp.EPILOGUE_BYTES)
    b = flops.k12_bound(pairs=1000, touched=70, live=90, out_bytes=512)
    assert b["k1"] == (23_000, 90 * 64 + 512)
    assert b["k2"] == (44_000 + 70 * 37, 70 * (64 + 72) + 1024)


def test_the_trace_reader_unions_device_time_and_names_the_gaps():
    from benchmark import trace

    dev = [("k_a", 0, 10), ("k_b", 5, 10), ("Memcpy HtoD", 30, 5),
           ("k_a", 50, 10)]
    host = [("step", 0, 100), ("aten::copy_", 14, 20), ("sync", 36, 10)]
    assert trace.busy_intervals(dev) == [[0, 15], [30, 35], [50, 60]]
    assert trace.busy_s(dev) == pytest.approx(30e-9)
    assert trace.top_ops(dev)[0] == ["k_a", pytest.approx(20e-9)]
    assert trace.idle_gaps(dev, host) == [
        ["step", pytest.approx(15e-9)], ["aten::copy_", pytest.approx(15e-9)]]
