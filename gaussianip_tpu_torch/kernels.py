"""The registry of the hand-written kernels' launch counters.

Each wrapper function that launches a kernel of csrc/ registers itself
with `_nvcc.counts`; importing this module imports every wrapper module,
so that `COUNTERS` holds them all:
    K1, K2          render/composite_cuda.py: composite_fwd_cuda,
                    composite_bwd_gaussians_cuda
    K3              ops/conv3x3_cuda.py: conv3x3_cuda (once a call), and
    K3_hopper,      per variant conv3x3_hopper, conv3x3_general
    K3_general
    K4_fwd, K4_bwd  ops/groupnorm_cuda.py: groupnorm_{fwd,bwd}_cuda
    K5_fwd, K5_bwd  ops/vae_attention_cuda.py: attention_{fwd,bwd}_cuda
A kernel launched from a replayed CUDA graph runs no Python: the graph's
owner takes each counter's rise during capture back out with `add(rise,
-1)` and adds it again at every replay with `add(rise)`.
"""

from __future__ import annotations

import torch

from ._nvcc import COUNTERS
from .ops import conv3x3_cuda, groupnorm_cuda, vae_attention_cuda  # noqa: F401
from .render import composite_cuda  # noqa: F401


def launches() -> dict:
    """{kernel: its launches so far} for every registered counter."""
    return {k: COUNTERS[k].launches for k in sorted(COUNTERS)}


def add(launches: dict, sign: int = 1) -> None:
    """Add sign x launches[k] to each named kernel's counter."""
    for k, n in launches.items():
        COUNTERS[k].launches += sign * n


def count_launches(fn, device="cuda"):
    """(fn(), {kernel: its launches during this call alone}) for every
    registered counter, the device synchronised before and after (a CUDA
    device only)."""
    sync = torch.device(device).type == "cuda"
    before = launches()
    if sync:
        torch.cuda.synchronize()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, {k: COUNTERS[k].launches - n for k, n in before.items()}
