"""The reference's arithmetic precision. By default every layer computes
in float32 (TF32 off, set by the caller). Inside `quantised("fp8")` the
input and the weight of every conv and dense layer of the diffusion and
LPIPS stacks are rounded to float8 e4m3 with one scale per tensor: the
control, one step below the bf16 that the configuration states."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
_MODE = {"quant": None}


@contextlib.contextmanager
def quantised(mode: str | None):
    """The block's layers round as `mode` says (None: float32)."""
    if mode not in (None, "fp8"):
        raise ValueError(f"unknown quantisation {mode!r}")
    _MODE["quant"] = mode
    try:
        yield
    finally:
        _MODE["quant"] = None


def quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded as the current mode says (itself in float32)."""
    if _MODE["quant"] is None:
        return x
    scale = (x.detach().abs().amax().float() / FP8_MAX).clamp(min=1e-30)
    y = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    # the rounding passes the gradient straight through
    return x + (y - x).detach()
