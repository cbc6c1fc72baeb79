"""Frozen copy of gaussianip_tpu_torch/guidance/ahds.py, plain PyTorch.

AHDS timestep scheduling and the ANPG guidance gradient (port of
gaussianip_tpu/guidance/ahds.py).

The schedule (the dual-gaussian fit and the annealed per-step timestep) is
host numpy, identical to the JAX package's. The step-windowed timestep
draw takes the raw integer draw `u` [B] in [0, 2**30) as an argument; the
gradients are torch on NCHW latents, so the per-pixel clip normalises over
dim 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

AHDS_N = 2400
AHDS_T0 = 799
MAX_T = 800
TGT_PROB_SUMS = (0.41, 0.21, 0.375)
RANGES = ((0, 350), (350, 450), (450, 800))
BOUNDS = ((200, 400), (20, 100), (100, 300))


def dual_gaussian_pdf(T, s1, s2, max_t: int = MAX_T):
    """Piecewise gaussian: exp(-(t-T)^2 / 2 s1^2) for t <= T else s2."""
    t = np.arange(max_t, dtype=np.float64)
    s = np.where(t <= T, s1, s2)
    w = np.exp(-((t - T) ** 2) / (2 * s * s))
    return w / w.sum()


def fit_dual_gaussian(tgt_prob_sums=TGT_PROB_SUMS, ranges=RANGES,
                      bounds=BOUNDS, max_t: int = MAX_T, grid: int = 48):
    """Dense grid search over the bounded (T, s1, s2) box minimising the
    squared range-mass error. The left piece of the pdf depends on (T, s1)
    only and the right on (T, s2), so the range masses factor into two
    [G, G, T] tables. Returns (pdf [max_t], (T, s1, s2))."""
    Ts = np.linspace(bounds[0][0], bounds[0][1], grid)
    s1s = np.linspace(bounds[1][0], bounds[1][1], grid)
    s2s = np.linspace(bounds[2][0], bounds[2][1], grid)
    t = np.arange(max_t, dtype=np.float64)
    d2 = (t[None, :] - Ts[:, None]) ** 2
    left_mask = t[None, :] <= Ts[:, None]
    wl = np.exp(-d2[:, None, :] / (2 * s1s[None, :, None] ** 2)) * \
        left_mask[:, None, :]
    wr = np.exp(-d2[:, None, :] / (2 * s2s[None, :, None] ** 2)) * \
        ~left_mask[:, None, :]
    lm = np.stack([wl[..., lo:hi].sum(-1) for lo, hi in ranges], -1)
    rm = np.stack([wr[..., lo:hi].sum(-1) for lo, hi in ranges], -1)
    lt = wl.sum(-1)
    rt = wr.sum(-1)
    mass = lm[:, :, None, :] + rm[:, None, :, :]
    total = lt[:, :, None, None] + rt[:, None, :, None]
    err = ((mass / total - np.asarray(tgt_prob_sums)) ** 2).sum(-1)
    i = np.unravel_index(np.argmin(err), err.shape)
    T_best, s1_best, s2_best = Ts[i[0]], s1s[i[1]], s2s[i[2]]
    best = dual_gaussian_pdf(T_best, s1_best, s2_best, max_t)
    return best.astype(np.float64), (T_best, s1_best, s2_best)


def chosen_t_schedule(pdf, n: int = AHDS_N, t0: int = AHDS_T0):
    """t_i = argmin_t |suffix_sum(t) - i/n| for i in [0, n): the annealed
    AHDS timestep per training step (a suffix-quantile inversion)."""
    suffix = np.cumsum(pdf[::-1])[::-1]
    targets = np.arange(n) / n
    idx = np.searchsorted(-suffix, -targets)
    idx = np.clip(idx, 0, len(pdf) - 1)
    prev = np.clip(idx - 1, 0, len(pdf) - 1)
    pick_prev = np.abs(suffix[prev] - targets) <= np.abs(suffix[idx] - targets)
    out = np.where(pick_prev, prev, idx).astype(np.int32)
    return np.maximum(out, 0)


class AHDSSchedule(NamedTuple):
    chosen_t: np.ndarray  # [N] int32
    chosen_t_min: int  # the last nonzero chosen t


def make_ahds_schedule(n: int = AHDS_N, t0: int = AHDS_T0) -> AHDSSchedule:
    pdf, _ = fit_dual_gaussian()
    ts = chosen_t_schedule(pdf, n, t0)
    nz = ts[ts != 0]
    return AHDSSchedule(ts, int(nz[-1]) if len(nz) else 1)


def timestep_window(sched: AHDSSchedule, step: int) -> tuple[int, int]:
    """[lo, hi) of the step's timestep draw:
      step <  700: [500, 800)
      step <  900: [400, cur_t + 50)
      step < 1400: [150, cur_t + 50)
      else:        [20,  cur_t + 50)   (or [20, t_min) once cur_t == 0)"""
    step = int(step)
    cur_t = int(sched.chosen_t[min(max(step, 0), len(sched.chosen_t) - 1)])
    lo = 500 if step < 700 else 400 if step < 900 else 150 if step < 1400 \
        else 20
    if step < 700:
        hi = 800
    else:
        hi = cur_t + 50 if cur_t != 0 else sched.chosen_t_min
    return lo, max(hi, lo + 1)


def sample_timesteps(sched: AHDSSchedule, u, step: int) -> torch.Tensor:
    """The step-windowed timestep draw from the raw integer draw u [B]."""
    lo, hi = timestep_window(sched, step)
    return lo + u.long() % (hi - lo)


def sds_weight(alphas_cumprod, t, strategy: str = "sds"):
    """w(t) [B, 1, 1, 1]."""
    a = alphas_cumprod[t]
    if strategy == "sds":
        w = 1.0 - a
    elif strategy == "uniform":
        w = torch.ones_like(a)
    elif strategy == "fantasia3d":
        w = (a ** 0.5) * (1 - a)
    else:
        raise ValueError(strategy)
    return w.reshape((-1, 1, 1, 1))


def anpg_grad(noise_pred_neg, noise_pred_text, noise_pred_null, t,
              alphas_cumprod, guidance_scale: float = 7.5,
              weighting_strategy: str = "sds", grad_clip_pixel: bool = True,
              grad_clip_threshold: float = 1.0):
    """ANPG 3-way decomposition:
      delta_c = gs * (e_text - e_null)
      delta_d = [t < 170] * e_null + [t >= 170] * (e_null - e_neg)
      grad = w(t) * (delta_c + delta_d), each pixel's channel vector
      clipped to norm grad_clip_threshold."""
    bs = t.shape[0]
    delta_c = guidance_scale * (noise_pred_text - noise_pred_null)
    mask = (t < 170).to(noise_pred_null.dtype).reshape(bs, 1, 1, 1)
    delta_d = mask * noise_pred_null + (1 - mask) * (noise_pred_null
                                                     - noise_pred_neg)
    grad = sds_weight(alphas_cumprod, t, weighting_strategy) * (delta_c
                                                                + delta_d)
    if grad_clip_pixel:
        gnorm = torch.linalg.vector_norm(grad, dim=1, keepdim=True) + 1e-8
        grad = torch.clamp(gnorm, max=grad_clip_threshold) * grad / gnorm
    return grad


def sds_grad(noise_pred_neg, noise_pred_pos, noise, t, alphas_cumprod,
             guidance_scale: float = 7.5, weighting_strategy: str = "sds",
             guidance_rescale: float = 0.0):
    """Plain 2-way CFG SDS gradient."""
    noise_pred = noise_pred_neg + guidance_scale * (noise_pred_pos
                                                    - noise_pred_neg)
    if guidance_rescale > 0.0:
        dims = tuple(range(1, noise_pred.dim()))
        std_pos = noise_pred_pos.std(dim=dims, correction=0, keepdim=True)
        std_cfg = noise_pred.std(dim=dims, correction=0, keepdim=True)
        rescaled = noise_pred * (std_pos / std_cfg)
        noise_pred = (guidance_rescale * rescaled
                      + (1 - guidance_rescale) * noise_pred)
    w = sds_weight(alphas_cumprod, t, weighting_strategy)
    return w * (noise_pred - noise)


def sds_loss(latents, grad, batch_size: int | None = None):
    """The loss whose gradient in `latents` is grad / B: a mean over a
    batch of B rows, B = batch_size (the whole batch's when `latents` are
    one data-parallel rank's rows), else latents' rows."""
    grad = torch.nan_to_num(grad)
    target = (latents - grad).detach()
    b = latents.shape[0] if batch_size is None else batch_size
    return 0.5 * ((latents - target) ** 2).sum() / b
