"""Frozen copy of gaussianip_tpu_torch/diffusion/scheduler.py, plain PyTorch.

DDIM scheduler math (port of gaussianip_tpu/diffusion/scheduler.py):
1000 train timesteps, scaled_linear betas 0.00085 -> 0.012,
set_alpha_to_one=False; add_noise and the deterministic DDIM update."""

from __future__ import annotations

from typing import NamedTuple

import torch


class DDIMSchedule(NamedTuple):
    betas: torch.Tensor  # [T]
    alphas_cumprod: torch.Tensor  # [T]
    final_alpha_cumprod: torch.Tensor  # scalar
    num_train_timesteps: int


def make_ddim_schedule(num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085, beta_end: float = 0.012,
                       set_alpha_to_one: bool = False,
                       device="cuda") -> DDIMSchedule:
    # scaled_linear: squared interpolation of the square-rooted endpoints
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=torch.float32,
                           device=device) ** 2
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    final = (torch.ones((), device=device) if set_alpha_to_one
             else alphas_cumprod[0])
    return DDIMSchedule(betas, alphas_cumprod, final, num_train_timesteps)


def _col(a, ndim: int):
    return a.reshape((-1,) + (1,) * (ndim - 1))


def add_noise(sched: DDIMSchedule, sample, noise, t):
    """x_t = sqrt(a_t) x_0 + sqrt(1 - a_t) eps; t: [B] int."""
    a = _col(sched.alphas_cumprod[t], sample.dim())
    return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise


def ddim_step(sched: DDIMSchedule, model_output, t, prev_t, sample):
    """Deterministic DDIM update x_t -> x_{t_prev} (eta 0, epsilon
    prediction, no thresholding)."""
    nd = sample.dim()
    a_t = _col(sched.alphas_cumprod[t], nd)
    a_prev = _col(torch.where(
        prev_t >= 0, sched.alphas_cumprod[torch.clamp(prev_t, min=0)],
        sched.final_alpha_cumprod), nd)
    pred_x0 = (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * model_output


def refine_timestep_ladder(num_inference_steps: int = 50,
                           num_train_timesteps: int = 1000, device="cuda"):
    """The stage-2 ladder: linspace(0, 999, 50).round(), descending."""
    t = torch.linspace(0, num_train_timesteps - 1, num_inference_steps,
                       device=device)
    return torch.round(t).to(torch.int32).flip(0)
