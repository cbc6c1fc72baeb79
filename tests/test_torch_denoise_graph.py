"""The guidance denoise's CUDA graph (gaussianip_tpu_torch/guidance/graph.py)
on the CPU, through the seam that stands for torch.cuda's capture:
`FakeCapture` runs the warm-up eagerly, runs the capture's Python while
CUDA reports a capture under way (as a card does), and keeps a graph whose
replay recomputes the captured arithmetic into the static output without
running the function's Python (no launch counted, no span opened), as a
replayed CUDA graph does. What only a card shows (the captured kernels,
replay against eager at the recipe's sizes) is chip_smoke.py's
`check_denoise_graph`.
"""

import contextlib
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussianip_tpu_torch import kernels
from gaussianip_tpu_torch.guidance import graph
from gaussianip_tpu_torch.guidance.graph import DenoiseGraph
from gaussianip_tpu_torch.utils import profiling

torch.set_num_threads(1)

K3_SITES = 67  # K3 launches of a SD1.5 ControlNet + UNet call, all Hopper
LAT = (12, 4, 64, 64)  # CFG batch 12 at 64^2 latents


@contextlib.contextmanager
def _cuda_capturing():
    """What torch.cuda reports on a card while its stream captures."""
    with mock.patch.object(torch.cuda, "is_initialized", lambda: True), \
            mock.patch.object(torch.cuda, "is_current_stream_capturing",
                              lambda: True):
        yield


class FakeGraph:
    def __init__(self, model, args, out):
        self.model, self.args, self.out = model, args, out

    def replay(self):
        with _cuda_capturing():
            self.out.copy_(self.model.arithmetic(*self.args))


class FakeCapture:
    def __init__(self):
        self.captures = 0
        self.rise = None  # the counters' rise while the capture ran

    def warm_up(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        self.captures += 1
        before = kernels.launches()
        with _cuda_capturing():
            out = fn(*args)
        self.rise = {k: n - before[k] for k, n in kernels.launches().items()}
        return FakeGraph(fn, args, out), out


class Model:
    """A stand-in for AHDSGuidance.predict_noise: each call counts the
    SD1.5 call's 67 K3 launches, all on the Hopper variant, opens the
    call's two spans, and returns a function of every input."""

    def __call__(self, lat, ctrl, t, ctx, added=None):
        kernels.COUNTERS["K3"].launches += K3_SITES
        kernels.COUNTERS["K3_hopper"].launches += K3_SITES
        with profiling.span("controlnet"):
            pass
        with profiling.span("unet"):
            return self.arithmetic(lat, ctrl, t, ctx, added)

    @staticmethod
    def arithmetic(lat, ctrl, t, ctx, added=None):
        y = lat * 2.0 + ctrl.mean() + t.float().mean() + ctx.mean()
        if added is not None:
            y = y + added[0].mean() + added[1].mean()
        return y


def _inputs(seed: int, lat=LAT, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    b = lat[0]
    return (torch.randn(lat, generator=g).to(dtype),
            torch.rand((b, 3, 32, 32), generator=g),
            torch.randint(20, 800, (b,), generator=g),
            torch.randn((b, 81, 16), generator=g))


def _graphs():
    """A DenoiseGraph that engages on CPU tensors, on the fake capture."""
    return DenoiseGraph(backend=FakeCapture(), rule=lambda device, shape:
                        True)


def _delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in kernels.launches().items()
            if n != before[k]}


@pytest.mark.parametrize("device,side,engaged", [
    ("cuda", 64, True),    # SD1.5 at 512^2: the graph
    ("cuda", 8, True),     # the command line's stub stack at 64^2
    ("cuda", 128, False),  # SDXL at 1024^2: bound by the device, eager
    ("cpu", 64, False),    # CPU tensors: always eager
    ("cpu", 128, False),
])
def test_the_rule(device, side, engaged):
    assert graph.engages(torch.device(device), (12, 4, side, side)) \
        is engaged


@pytest.mark.parametrize("sign", [1, -1, 3])
def test_add_moves_each_named_counter_by_sign_times_its_count(sign):
    before = kernels.launches()
    kernels.add({"K3": K3_SITES, "K3_hopper": K3_SITES, "K1": 0}, sign)
    assert _delta(before) == {"K3": sign * K3_SITES,
                              "K3_hopper": sign * K3_SITES}
    kernels.add({"K3": K3_SITES, "K3_hopper": K3_SITES}, -sign)
    assert kernels.launches() == before


def test_capture_leaves_the_counters_and_each_replay_adds_its_launches():
    graphs, model = _graphs(), Model()
    before = kernels.launches()
    use = dict(graph.USE)
    graphs(model, *_inputs(0))
    # the capture's Python counted a call; that rise was taken back out, so
    # the first call counts its warm-up alone
    assert graphs.backend.rise["K3"] == K3_SITES
    assert _delta(before) == {"K3": K3_SITES, "K3_hopper": K3_SITES}
    n = 5
    before = kernels.launches()
    for i in range(n):
        graphs(model, *_inputs(1 + i))
    assert _delta(before) == {"K3": n * K3_SITES, "K3_hopper": n * K3_SITES}
    assert graph.USE == {
        **use, "captures": use["captures"] + 1,
        "replays": use["replays"] + n}


def test_replays_read_each_call_s_inputs():
    """Two input sets after the capture: each replay equals the eager
    function on its own inputs (a stale static buffer would not), and
    returns the graph's static output."""
    graphs, model = _graphs(), Model()
    first = graphs(model, *_inputs(0))
    torch.testing.assert_close(first, Model.arithmetic(*_inputs(0)),
                               rtol=0, atol=0)
    outs = []
    for seed in (1, 2):
        got = graphs(model, *_inputs(seed))
        torch.testing.assert_close(got, Model.arithmetic(*_inputs(seed)),
                                   rtol=0, atol=0)
        outs.append(got.data_ptr())
    assert outs[0] == outs[1]


def test_a_new_signature_captures_anew_and_a_known_one_replays():
    graphs, model = _graphs(), Model()
    g = torch.Generator().manual_seed(3)
    added = (torch.randn((12, 32), generator=g), torch.rand((12, 6)))
    calls = [_inputs(0), _inputs(1, lat=(6, 4, 64, 64)),
             _inputs(2, dtype=torch.float64), (*_inputs(3), added),
             _inputs(4), _inputs(5, lat=(6, 4, 64, 64)), (*_inputs(6), added)]
    use = dict(graph.USE)
    for args in calls:
        torch.testing.assert_close(graphs(model, *args),
                                   Model.arithmetic(*args), rtol=0, atol=0)
    assert graphs.backend.captures == 4
    assert graph.USE["captures"] - use["captures"] == 4
    assert graph.USE["replays"] - use["replays"] == 3


def test_the_rule_declined_calls_the_function_and_counts_it_eager():
    graphs = DenoiseGraph(backend=FakeCapture())
    use = dict(graph.USE)
    before = kernels.launches()
    out = graphs(Model(), *_inputs(0))
    torch.testing.assert_close(out, Model.arithmetic(*_inputs(0)),
                               rtol=0, atol=0)
    assert graphs.backend.captures == 0
    assert _delta(before) == {"K3": K3_SITES, "K3_hopper": K3_SITES}
    assert graph.USE == {**use, "eager": use["eager"] + 1}


def test_a_span_opened_under_capture_records_nothing():
    """Under the profiler: the capturing call records its warm-up's spans
    once (not the capture's), a replay only the caller's span around it."""
    graphs, model = _graphs(), Model()
    profiling.spans()
    names = []
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (0, 1):
            with profiling.span("denoise", step=seed):
                graphs(model, *_inputs(seed))
            names.append([(r["name"], r["parent"])
                          for r in profiling.spans()])
        with _cuda_capturing(), profiling.span("denoise", step=2):
            pass
        assert profiling.spans() == []
    assert names == [[("denoise", None), ("controlnet", "denoise"),
                      ("unet", "denoise")], [("denoise", None)]]


@pytest.fixture(scope="module")
def stub():
    """The weight-free tiny stack at 32^2 images (4^2 latents), 2 views."""
    from gaussianip_tpu_torch.system import pipeline

    guid = pipeline.build_stub_guidance_stack("a person", "bad quality",
                                              image_size=32, device="cpu")
    g = torch.Generator().manual_seed(11)
    b = 2
    rgb = torch.rand((b, 32, 32, 3), generator=g)
    control = torch.rand((b, 32, 32, 3), generator=g)
    aux = {"all_vis": torch.zeros(b), "elevation": torch.zeros(b),
           "azimuth": torch.tensor([-60.0, 120.0]), "center": torch.zeros(b),
           "camera_distances": torch.full((b,), 1.5), "batch_size": b}
    return guid, rgb, control, aux


def _guided(guid, rgb, control, aux, step: int, seed: int):
    draws = guid.sample_noise(torch.Generator().manual_seed(seed), rgb.shape,
                              "cpu")
    return guid(step, draws, rgb, control, aux)


def test_the_guidance_on_cpu_tensors_stays_eager(stub):
    guid, rgb, control, aux = stub
    use = dict(graph.USE)
    _guided(guid, rgb, control, aux, 100, 0)
    assert graph.USE == {**use, "eager": use["eager"] + 1}
    assert guid.denoise_graph._graphs == {}


def test_the_guidance_through_a_graph_equals_its_eager_call(stub,
                                                             monkeypatch):
    """AHDSGuidance.__call__ with its denoise on the fake capture (the rule
    forced to engage on CPU tensors) returns the eager call's loss, grad
    norm and timesteps bit for bit at three steps: the capturing call and
    two replays on other draws."""
    guid, rgb, control, aux = stub
    eager = [_guided(guid, rgb, control, aux, step, seed)
             for step, seed in ((100, 1), (900, 2), (1500, 3))]
    graphs = DenoiseGraph(backend=FakeCapture(),
                          rule=lambda device, shape: True)
    monkeypatch.setattr(guid, "denoise_graph", graphs)

    class Replay(FakeGraph):
        def replay(self):
            with _cuda_capturing():
                self.out.copy_(guid.predict_noise(*self.args))

    monkeypatch.setattr(
        graphs.backend, "capture", lambda fn, args: (
            lambda out: (Replay(None, args, out), out))(fn(*args)))
    use = dict(graph.USE)
    for want, (step, seed) in zip(eager, ((100, 1), (900, 2), (1500, 3))):
        got = _guided(guid, rgb, control, aux, step, seed)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert graph.USE == {
        **use, "captures": use["captures"] + 1,
        "replays": use["replays"] + 2}
