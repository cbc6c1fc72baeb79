"""Frozen copy of gaussianip_tpu_torch/model/adam.py, plain PyTorch.

Per-group Adam for the gaussian parameters (port of
gaussianip_tpu/model/adam.py): torch-Adam semantics (bias correction, eps
added after the sqrt) with the reference's per-field learning rates. Padded
rows have zero gradients and zero moments, so their updates are no-ops."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.transforms import expon_lr
from .gaussians import PARAM_FIELDS, GaussianState


@dataclass(frozen=True)
class AdamHyper:
    position_lr_init: float = 5e-5
    position_lr_final: float = 2.5e-5
    position_lr_delay_mult: float = 0.5
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0125
    opacity_lr: float = 0.01
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    spatial_lr_scale: float = 4.0  # cameras_extent
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    percent_dense: float = 0.01


@dataclass
class AdamState:
    m: dict
    v: dict
    count: int  # number of applied steps


def init_adam(state: GaussianState) -> AdamState:
    return AdamState(
        m={f: torch.zeros_like(getattr(state, f)) for f in PARAM_FIELDS},
        v={f: torch.zeros_like(getattr(state, f)) for f in PARAM_FIELDS},
        count=0,
    )


def field_lrs(hyper: AdamHyper, step: int) -> dict:
    """Learning rate per field at `step` (xyz exp-decayed)."""
    xyz_lr = expon_lr(
        step,
        hyper.position_lr_init * hyper.spatial_lr_scale,
        hyper.position_lr_final * hyper.spatial_lr_scale,
        lr_delay_steps=0,
        lr_delay_mult=hyper.position_lr_delay_mult,
        max_steps=hyper.position_lr_max_steps,
    )
    return {
        "xyz": xyz_lr,
        "f_dc": hyper.feature_lr,
        "f_rest": hyper.feature_lr / 20.0,
        "opacity": hyper.opacity_lr,
        "scaling": hyper.scaling_lr,
        "rotation": hyper.rotation_lr,
    }


@torch.no_grad()
def adam_step(state: GaussianState, grads: dict, opt: AdamState,
              hyper: AdamHyper, step: int):
    """One optimizer step; `step` drives the xyz schedule. Returns
    (state, opt) as new tensors."""
    lrs = field_lrs(hyper, step)
    t = opt.count + 1
    bc1 = 1.0 - hyper.beta1 ** t
    bc2 = 1.0 - hyper.beta2 ** t
    new_m, new_v, upd = {}, {}, {}
    for f in PARAM_FIELDS:
        g = grads[f]
        m = hyper.beta1 * opt.m[f] + (1 - hyper.beta1) * g
        v = hyper.beta2 * opt.v[f] + (1 - hyper.beta2) * g * g
        upd[f] = getattr(state, f) - lrs[f] * (m / bc1) / (
            torch.sqrt(v / bc2) + hyper.eps)
        new_m[f] = m
        new_v[f] = v
    return state.replace(**upd), AdamState(m=new_m, v=new_v, count=t)
