"""The comparison that decides `correct` for a training cell. Set-up drives
the training object through its first steps by the window's own call; the
plain reference follows the same steps from the same inputs. The numbers
that a cell's limits name are compared, each against its limit:

  loss    the largest gap of a step's loss, |program - reference| over
          |reference|, over the steps;
  grad    the first gradient as the optimizer got it (Adam's first moment
          after one step over 1 - beta1), by the worst leaf: the gap of
          the two norms over the larger of the reference's norm of that
          leaf and of the median leaf;
  change  the parameters' change after the steps, by the worst leaf in the
          same measure, over the leaves whose first gradient in the
          reference is at least GRAD_FLOOR of the median leaf's (a leaf
          with a gradient of nought moves by round-off alone);
  grad_diff  the first gradient's difference, by the worst leaf: the norm
          of program - reference over the larger of the reference's norm
          of that leaf and of the median leaf. A gap of norms is blind to
          an error across the gradient's direction; this number sees it.
"""

from __future__ import annotations

import statistics

import torch

GRAD_FLOOR = 1e-3


def train_readings(step, ts, n_steps: int, beta1: float, fields) -> tuple:
    """Runs `step(ts) -> (ts, metrics)` n_steps times. -> (ts, readings):
    each step's loss, the first gradient's norm per leaf and the gradient
    itself (on the host), the change's norm per leaf (leaves with no
    elements left out)."""
    fields = [f for f in fields if getattr(ts.gaussians, f).numel()]
    p0 = {f: getattr(ts.gaussians, f).detach().clone() for f in fields}
    losses, grad, grad_vec = [], {}, {}
    for i in range(n_steps):
        ts, m = step(ts)
        losses.append(float(m["loss"]))
        if i == 0:
            grad_vec = {f: ts.opt.m[f].float().cpu() / (1.0 - beta1)
                        for f in fields}
            grad = {f: float(torch.linalg.vector_norm(ts.opt.m[f].float()))
                    / (1.0 - beta1) for f in fields}
    change = {f: float(torch.linalg.vector_norm(
        getattr(ts.gaussians, f).float() - p0[f].float())) for f in fields}
    return ts, {"loss": losses, "grad": grad, "grad_vec": grad_vec,
                "change": change}


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[f] for f in leaves)
    return max(abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30)
               for f in leaves)


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of two readings."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][f] for f in leaves)
    moved = [f for f in leaves if ref["grad"][f] >= GRAD_FLOOR * med]
    diff = {f: float(torch.linalg.vector_norm(
        prog["grad_vec"][f].double() - ref["grad_vec"][f].double()))
        for f in leaves}
    return {"loss": loss, "grad": _leaf_gap(prog["grad"], ref["grad"],
                                            leaves),
            "change": _leaf_gap(prog["change"], ref["change"], moved),
            "grad_diff": max(diff[f] / max(ref["grad"][f], med, 1e-30)
                             for f in leaves)}
