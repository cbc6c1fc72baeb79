"""The guidance denoise replayed from a CUDA graph.

At the SD1.5 recipe's 64^2 latents one ControlNet + UNet call on the CFG
batch is some 6,000 small kernels, which the host enqueues one by one
more slowly than the device runs them. `DenoiseGraph` captures the call
once per input signature (each tensor argument's shape, dtype and device)
and replays it after that, so a step's denoise costs the host a few
copies and one graph launch.

Where it engages (`engages`): a CUDA device and latents of at most
MAX_LATENT^2, where the host sets the pace. Larger latents (SDXL's and
FLUX's 128^2) keep the eager call for its spans (utils/profiling.py): a
span records nothing inside a graph, and SDXL's per-layer timings read
the `unet`, `controlnet` and `transformer` spans, FLUX's the
`controlnet`, `flux`, `double_block` and `single_block` spans. The graph would not slow them: on
an H100 at 700 W, SDXL's guided step took 561.8 ms from a graph against
568.1 ms eager (medians of two runs each). CPU tensors always run
eagerly.

The first call of a signature runs the function eagerly on a side stream
(the capture's warm-up, whose result that call returns), then captures it
on static copies of the inputs. Every later call copies its inputs into
those buffers on the current stream, replays, and returns the graph's
static output, which the next replay of the signature overwrites. Nothing
in the captured function may read the host or copy from pageable memory.

The graph reads the models' parameters by address: an in-place change of
a weight is seen by the next replay; a parameter rebound to a new tensor
after capture is not (a new DenoiseGraph captures anew).

Launch counters (kernels.py): capture runs no kernel, so the capture's
rise of every registered counter is taken back out, and added again at
every replay; the counters then hold what the device ran. `USE` counts the
mechanism's use: "captures" (one per input signature; that call runs
eagerly, as the capture's warm-up), "replays", and "eager" (calls that the
rule keeps eager). Spans
(utils/profiling.py) opened during capture record nothing; a span around
a replay records as usual.
"""

from __future__ import annotations

import torch

from .. import kernels

# the largest latent side that replays from a graph (SD1.5's 512^2 images
# at the VAE's 8x downscale); above it the call stays eager, spans and all
MAX_LATENT = 64

USE = {"captures": 0, "replays": 0, "eager": 0}


def engages(device, shape) -> bool:
    """The rule: a graph for latents of `shape` [..., h, w] on `device`."""
    return (torch.device(device).type == "cuda"
            and max(shape[-2:]) <= MAX_LATENT)


def _map(fn, x):
    """fn over the tensors of x: a tensor, None or a tuple of them."""
    if isinstance(x, tuple):
        return tuple(_map(fn, y) for y in x)
    return None if x is None else fn(x)


def _leaves(x) -> list:
    out = []
    _map(out.append, x)
    return out


class CudaCapture:
    """torch.cuda's side of a capture, as `torch.cuda.graph` recommends:
    the warm-up on a side stream, the capture on that stream into a graph
    with its own memory pool. The seam that the CPU tests replace."""

    def __init__(self):
        self._stream = None

    def warm_up(self, fn, args) -> torch.Tensor:
        cur = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn(*args)
        cur.wait_stream(self._stream)
        out.record_stream(cur)
        return out

    def capture(self, fn, args):
        """(the graph, its static output)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            out = fn(*args)
        return graph, out


class DenoiseGraph:
    """`graphs(fn, *args)`: fn(*args) eagerly where `rule(device, shape)`
    of args[0] declines, else replayed from the graph of the arguments'
    signature (see the module's docstring). The arguments are tensors,
    None, or tuples of them; fn returns one tensor. One DenoiseGraph serves
    one function: it keeps only graphs, not fn."""

    def __init__(self, backend=None, rule=engages):
        self.backend = backend if backend is not None else CudaCapture()
        self.rule = rule
        self._graphs = {}

    def __call__(self, fn, *args) -> torch.Tensor:
        x = args[0]
        if not self.rule(x.device, x.shape):
            USE["eager"] += 1
            return fn(*args)
        key = _map(lambda t: (tuple(t.shape), t.dtype, t.device), args)
        got = self._graphs.get(key)
        if got is None:
            return self._capture(key, fn, args)
        static, graph, out, rise = got
        for buf, a in zip(_leaves(static), _leaves(args)):
            buf.copy_(a)
        graph.replay()
        kernels.add(rise)
        USE["replays"] += 1
        return out

    def _capture(self, key, fn, args) -> torch.Tensor:
        static = _map(torch.clone, args)
        out = self.backend.warm_up(fn, static)
        before = kernels.launches()
        graph, static_out = self.backend.capture(fn, static)
        rise = {k: n - before[k] for k, n in kernels.launches().items()
                if n != before[k]}
        kernels.add(rise, -1)
        self._graphs[key] = (static, graph, static_out, rise)
        USE["captures"] += 1
        return out
