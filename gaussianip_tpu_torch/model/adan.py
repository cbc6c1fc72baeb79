"""Adan (Adaptive Nesterov Momentum) as a torch.optim.Optimizer (port of
gaussianip_tpu/model/adan.py, the no-restart path).

With the JAX package's parameterisation (b = 1 - beta; defaults 0.02,
0.08, 0.01, i.e. betas (0.98, 0.92, 0.99)):

  diff = g - g_prev (0 on the first step)
  m = (1 - b1) m + b1 g
  v = (1 - b2) v + b2 diff
  n = (1 - b3) n + b3 (g + (1 - b2) diff)^2
  u = (m / bc1 + (1 - b2) v / bc2) / (sqrt(n / bc3) + eps)
  p = (p - lr u) / (1 + lr weight_decay)

with the bias corrections bc_i = 1 - (1 - b_i)^t on the step count t."""

from __future__ import annotations

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, b1: float = 0.02,
                 b2: float = 0.08, b3: float = 0.01, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, b3=b3, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2, b3 = (group[k] for k in ("lr", "b1", "b2", "b3"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("m", "v", "n", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                diff = (torch.zeros_like(g) if st["step"] == 0
                        else g - st["prev_grad"])
                st["step"] += 1
                t = st["step"]
                bc1 = 1 - (1 - b1) ** t
                bc2 = 1 - (1 - b2) ** t
                bc3 = 1 - (1 - b3) ** t
                m = st["m"].mul_(1 - b1).add_(b1 * g)
                v = st["v"].mul_(1 - b2).add_(b2 * diff)
                u = g + (1 - b2) * diff
                n = st["n"].mul_(1 - b3).add_(b3 * (u * u))
                upd = (m / bc1 + (1 - b2) * v / bc2) / (
                    torch.sqrt(n / bc3) + group["eps"])
                p.sub_(lr * upd)
                if group["weight_decay"] > 0:
                    p.div_(1 + lr * group["weight_decay"])
                st["prev_grad"].copy_(g)
        return loss
