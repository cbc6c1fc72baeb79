"""The port's spans (gaussianip_tpu_torch/utils/profiling.py) in the
stage-1 and stage-3 steps, on the CPU at tiny sizes (the weight-free stub
guidance stack of system/pipeline.py, a 2-stage LPIPS), and what the
benchmark's span metrics read from them (benchmark/spans.py)."""

import argparse

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans as bspans
from gaussianip_tpu_torch.model.gaussians import PARAM_FIELDS
from gaussianip_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (name, parent), in the order the spans open; the stub stack's
# ControlNet holds 2 transformer layers, its UNet 4
TABLE = {
    "stage1": [("stage1.step", None), ("render", "stage1.step"),
               ("vae_encode", "stage1.step"), ("denoise", "stage1.step"),
               ("controlnet", "denoise")]
    + [("transformer", "controlnet")] * 2 + [("unet", "denoise")]
    + [("transformer", "unet")] * 4
    + [("backward", "stage1.step"), ("vae_encode.backward", "backward"),
       ("render.backward", "backward"), ("adam", "stage1.step")],
    "stage3": [("stage3.step", None), ("render", "stage3.step"),
               ("loss", "stage3.step"), ("backward", "stage3.step"),
               ("loss.backward", "backward"),
               ("render.backward", "backward"), ("adam", "stage3.step")],
}
SPLITS = ("vae_encode.backward", "loss.backward", "render.backward")
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def steps():
    """{"stage1": step(ts) -> (ts, metrics), "stage3": ...} and the
    start state (100 points, capacity 256; stage 1 at 2 views of 32^2,
    stage 3 at 4 orbit views of 64^2)."""
    from gaussianip_tpu_torch.data.sampler import (CameraSamplerConfig,
                                                   refine_orbit_batch)
    from gaussianip_tpu_torch.diffusion.lpips import LPIPS
    from gaussianip_tpu_torch.model.adam import AdamHyper
    from gaussianip_tpu_torch.model.gaussians import create_from_pcd
    from gaussianip_tpu_torch.ops.knn import mean_dist2_3nn
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import pipeline, stage1, stage3

    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(5)
    pts = torch.tensor(rng.normal(0, 0.3, (100, 3)), dtype=torch.float32)
    cols = torch.tensor(rng.uniform(0, 1, (100, 3)), dtype=torch.float32)
    ts = stage1.init_train_state(create_from_pcd(
        pts, cols, 256, mean_dist2_3nn(pts), device="cpu"))._replace(step=4)
    guid = pipeline.build_stub_guidance_stack("a person", "bad quality",
                                              image_size=32, device="cpu")
    s1 = stage1.make_train_step(
        stage1.Stage1Config(render_height=32, render_width=32),
        CameraSamplerConfig(height=32, width=32, batch_size=2),
        RenderConfig(d_max=16), AdamHyper(), guid,
        rng.normal(0, 0.3, (18, 3)).astype(np.float32))
    s3 = stage3.make_stage3_step(
        stage3.Stage3Config(height=64, width=64, crop_y=(4, 44),
                            crop_x=(10, 40)),
        RenderConfig(), AdamHyper(),
        refine_orbit_batch(32, 17.0, 1.5, 70.0, 64, 64, device="cpu"),
        torch.rand((32, 20, 15, 3), generator=gen),
        pipeline.init_random_(LPIPS(((8, 1), (16, 1))),
                              gen).requires_grad_(False))
    ids = torch.tensor([0, 5, 9, 20])
    return {"stage1": lambda ts: s1(ts, torch.Generator().manual_seed(7)),
            "stage3": lambda ts: s3(ts, ids)}, ts


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.spans()
    yield
    profiling.spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_a_step_records_the_spans_of_its_table(steps, stage):
    fns, ts = steps
    _profiled(lambda: fns[stage](ts))
    got = profiling.spans()
    assert [(r["name"], r["parent"]) for r in got] == TABLE[stage]
    assert {r["step"] for r in got} == {ts.step}
    by = {r["name"]: r for r in got}
    for r in got:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"], r["name"]
    # the backward's two parts meet where the render's gradient is complete
    before, after = [r for r in got if r["parent"] == "backward"]
    assert before["start_ns"] == by["backward"]["start_ns"]
    assert before["end_ns"] == after["start_ns"]
    assert after["end_ns"] == by["backward"]["end_ns"]


@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_with_no_profiler_a_step_records_and_hooks_nothing(steps, stage,
                                                           monkeypatch):
    """Off, the spans register no hook on the render's output and record
    nothing, and the step's results equal a profiled step's bit for bit."""
    from gaussianip_tpu_torch.system import stage1, stage3

    fns, ts = steps
    hooked = []
    real = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook", lambda t, fn: (
        hooked.append(t), real(t, fn))[1])
    outs = []
    mod = {"stage1": stage1, "stage3": stage3}[stage]
    render = mod.render
    monkeypatch.setattr(mod, "render", lambda *a, **k: (
        outs.append(render(*a, **k)), outs[-1])[1])
    ts_off, m_off = fns[stage](ts)
    assert hooked == [] and profiling.spans() == []
    (ts_on, m_on), _ = _profiled(lambda: fns[stage](ts))
    assert [t is outs[1].rgb for t in hooked] == [True]
    assert len(profiling.spans()) == len(TABLE[stage])
    assert ts_off.gaussians.n_active == ts_on.gaussians.n_active
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(ts_off.gaussians, f),
                           getattr(ts_on.gaussians, f))
        assert torch.equal(ts_off.opt.m[f], ts_on.opt.m[f])
        assert torch.equal(ts_off.opt.v[f], ts_on.opt.v[f])
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(ts_off.stats, f), getattr(ts_on.stats, f))
    assert ts_off.step == ts_on.step == ts.step + 1
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(torch.as_tensor(m_off[k]),
                           torch.as_tensor(m_on[k])), k


@pytest.mark.parametrize("stage", ["stage1", "stage3"])
def test_span_ranges_lie_on_the_records_clock(steps, stage):
    """Each span's host row in the profiler lies inside its record's
    time.time_ns() interval (1 ms of slack at either end) and is no user
    annotation; the backward's two parts have no row of their own."""
    fns, ts = steps
    _, prof = _profiled(lambda: fns[stage](ts))
    got = profiling.spans()
    names = {name for name, _ in TABLE[stage]}
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            rows.setdefault(e.name(), []).append(e)
    assert set(rows) == names - set(SPLITS)
    for name, events in rows.items():
        recs = [r for r in got if r["name"] == name]
        assert len(recs) == len(events), name
        for r, e in zip(recs, sorted(events, key=lambda e: e.start_ns())):
            assert not e.is_user_annotation()
            assert str(e.device_type()).endswith("CPU")
            assert r["start_ns"] - MS <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= r["end_ns"] + MS


def test_spans_empties_the_table_and_has_no_device_time_off_a_card():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", step=3, device="cpu"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    got = profiling.spans()
    assert [(r["name"], r["parent"], r["step"], r["device_ms"])
            for r in got] == [("outer", None, 3, None),
                              ("inner", "outer", 3, None)]
    assert profiling.spans() == []


def test_trace_shows_the_spans_among_its_host_ranges(tmp_path):
    import json

    with profiling.trace(str(tmp_path)):
        with profiling.span("stage1.step", step=0, device="cpu"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "stage1.step" in names
    assert [r["name"] for r in profiling.spans()] == ["stage1.step"]


def test_events_on_a_card_give_device_ms_after_one_synchronise(monkeypatch):
    """With a CUDA device a span records one event at entry and one at exit
    (here stand-ins that carry a clock), and spans() synchronises once and
    returns their elapsed ms; off, it records no event."""
    made, synced = [], []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            made.append(self)

        def record(self, stream):
            self.ms = len(made) * 2.5

        def elapsed_time(self, end):
            return end.ms - self.ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: d)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    with profiling.span("off", device="cuda"):
        pass
    assert made == [] and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", step=1, device="cuda"):
            with profiling.span("inner"):
                pass
    assert len(made) == 4 and synced == []
    got = profiling.spans()
    assert synced == [torch.device("cuda")]
    assert [(r["name"], r["device_ms"]) for r in got] == [("outer", 7.5),
                                                          ("inner", 2.5)]


def _ctx(records, units=2):
    """A traced run's context by hand: device ops (name, start ns, ns) of
    two units, busy 50 ns, gaps of 5, 15, 10 and 30 ns opening at 10, 25,
    50 and 70; 40 ns of untraced idle a unit."""
    dev = [("k", 0, 10), ("k", 15, 10), ("k", 40, 10), ("Memcpy", 60, 10),
           ("k", 100, 10)]
    return argparse.Namespace(trace={"device": dev, "host": [],
                                     "units": units, "window_s": 1.0},
                              unit_s=65e-9, work={}, entry=None)


def _rec(name, step, start, end, device_ms=None):
    return {"name": name, "parent": None, "step": step, "start_ns": start,
            "end_ns": end, "device_ms": device_ms}


def test_span_metrics_read_the_last_units_idle_by_owner(monkeypatch):
    recs = [_rec("render", 6, 48, 55, 100.0),  # an older step: not read
            _rec("render", 7, 8, 20, 1.0), _rec("denoise", 7, 24, 45, 4.0),
            _rec("render.backward", 8, 65, 75, 2.0)]
    reads = []
    monkeypatch.setattr(profiling, "spans",
                        lambda: (reads.append(1), list(recs))[1])
    ctx = _ctx(recs)
    # the render owns the gaps opening at 10 and 70: 35 of 60 ns of idle
    assert bspans.idle_ms(ctx, "render", "render.backward") == \
        pytest.approx(35 / 60 * 40e-9 * 1e3)
    assert bspans.idle_ms(ctx, "denoise") == pytest.approx(
        15 / 60 * 40e-9 * 1e3)
    assert bspans.device_ms(ctx, "render", "render.backward") == 1.5
    assert bspans.host_ms(ctx, "denoise") == pytest.approx(21e-6 / 2)
    assert bspans.device_ms(ctx, "adam") is None
    assert reads == [1]  # read from the program once, kept for the rest
    ctx = _ctx(recs)
    recs[1]["device_ms"] = None
    assert bspans.device_ms(ctx, "render", "render.backward") is None


def test_span_metrics_of_a_program_without_spans_read_nothing(monkeypatch):
    from benchmark import run

    monkeypatch.delattr(profiling, "spans")
    names = ("render_ms.stage1", "denoise_enqueue_ms.stage1",
             "render_idle_ms.stage1", "lpips_ms.stage3")
    for name in names:
        assert run.reader(name)(_ctx([])) is None
