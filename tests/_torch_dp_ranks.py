"""What the ranks of tests/test_torch_parallel.py run. parallel.mesh.spawn
starts each rank as a new process that imports this module by name, so it
imports torch and the port only. Each case is a function `case(group,
*args)`; with group=None it is the single-process run of the same case."""

from __future__ import annotations

import numpy as np
import torch

from gaussianip_tpu_torch.parallel.mesh import (
    all_max, all_sum, all_sum_many, check_replicated, gather_rows,
    global_max, local_rows, replicated, row_span, state_digest)


def run_cases(group, cases: dict) -> dict:
    """Every case of `cases` (name -> (function name, args)) in turn."""
    return {name: globals()[fn](group, *args)
            for name, (fn, args) in cases.items()}


def collectives(group, x, depth):
    """The row split and every collective on rank-dependent inputs: x
    [n, 3] float (each rank adds rank + 1 to its copy), depth [W, k]
    (rank r's elements are row r)."""
    r = group.rank
    mine = x + (r + 1)
    lo, hi = row_span(group, x.shape[0] + 1)
    flat = all_sum_many(group, [mine, mine[:, 0].to(torch.float32)])
    d = depth[r].clone().requires_grad_(True)
    m = global_max(group, d)
    (gd,) = torch.autograd.grad(m * (r + 1.0), d)
    bad = None
    try:
        check_replicated(group, {"x": mine, "n": 3})
    except RuntimeError as e:
        bad = str(e)
    check_replicated(group, {"x": x, "n": 3})
    return {
        "rows": local_rows(group, x), "span": (lo, hi),
        "sum": all_sum(group, mine), "max": all_max(group, mine),
        "imax": all_max(group, (mine * 10).to(torch.int32)),
        "any": all_max(group, mine[:, 0] > x.shape[0] + 1.5),
        "many": flat,
        "gather": gather_rows(group, torch.full((hi - lo, 2), float(r)),
                              x.shape[0] + 1),
        "bcast": replicated(group, {"a": mine, "b": [mine[0]]}),
        "gmax": m.detach(), "gmax_grad": gd, "bad": bad,
    }


def stage1(group, state_np, points3d, cfgs, guidance, steps, densify=None):
    """make_inner_step on each (batch, draws) of `steps` from the state
    state_np (the state after each step in "states"), then (densify =
    (noise, keyword arguments)) one densify_and_prune; the state is checked
    equal on every rank after both."""
    from gaussianip_tpu_torch.model.densify import densify_and_prune
    from gaussianip_tpu_torch.system.stage1 import (TrainState,
                                                    make_inner_step,
                                                    train_state_from_numpy)

    s1, cam, adam, rcfg = cfgs
    ts = replicated(group, train_state_from_numpy(state_np, "cpu"))
    inner = make_inner_step(s1, cam, rcfg, adam, guidance, points3d,
                            group=group)
    metrics, states = [], []
    for batch, draws in steps:
        ts, m = inner(ts, batch, draws)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(ts)
    check_replicated(group, ts, "stage 1")
    out = {"metrics": metrics, "states": states, "ts": ts}
    if densify is not None:
        noise, kw = densify
        g, opt, stats, dropped = densify_and_prune(
            ts.gaussians, ts.opt, ts.stats, noise, **kw)
        out["densified"] = TrainState(g, opt, stats, ts.step)
        check_replicated(group, out["densified"], "densify")
    out["digest"] = state_digest(out.get("densified", ts))[1]
    return out


def stage3(group, state_np, cfgs, orbit, targets, lpips, view_ids):
    """make_stage3_step on each row of view_ids from the state state_np;
    the state is checked equal on every rank."""
    from gaussianip_tpu_torch.system.stage1 import train_state_from_numpy
    from gaussianip_tpu_torch.system.stage3 import make_stage3_step

    s3, rcfg, adam = cfgs
    ts = replicated(group, train_state_from_numpy(state_np, "cpu"))
    step = make_stage3_step(s3, rcfg, adam, orbit, targets, lpips, group)
    metrics, states = [], []
    for ids in view_ids:
        ts, m = step(ts, ids)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(ts)
    check_replicated(group, ts, "stage 3")
    return {"metrics": metrics, "states": states, "ts": ts,
            "digest": state_digest(ts)[1]}


def refine(group, models, images, control, contexts, noise, dense_batch):
    """refine_views with its phase calls; the refined views are checked
    equal on every rank."""
    from gaussianip_tpu_torch.system.refine import refine_views

    phases = []
    out = refine_views(models, images, control, contexts, noise, num_steps=1,
                       dense_batch=dense_batch, on_phase=phases.append,
                       group=group)
    check_replicated(group, out, "refine")
    return {"images": out, "phases": phases}


def fail_on_rank1(group):
    """Rank 1 raises; rank 0 then waits in a collective."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    all_sum(group, torch.ones(1))
    return np.zeros(1)


def face_identity(group, photo: str, irr: str):
    """launch's face identity of two PNGs (rank 0's on every rank) and the
    rank's own pipeline.face_identity."""
    from gaussianip_tpu_torch import launch
    from gaussianip_tpu_torch.system import pipeline as pl

    g_cfg = {"pil_image_faceid_path": photo, "irr_pil_image_path": irr}
    return {"launch": launch._face_identity(g_cfg, group),
            "own": pl.face_identity(photo, irr)}
