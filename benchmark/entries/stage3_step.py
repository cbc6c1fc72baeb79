"""Entry `stage3_step`: the stage-3 reconstruction step of the port
(system/stage3.py:make_stage3_step, in train_stage3's schedule), run back
to back on one training state. A unit is one step: 4 of the 32 refine-orbit
views at 1024^2 (K1 / K2), the crop and the halving, 10 * L1 + 15 * LPIPS
(VGG16, float32) against the refined targets, Adam at the global step, and
after the step of index `densify_step` the stage's one densify_and_prune.

The training state starts at the workload's `start_step` (a fresh Adam
state on the seed's avatar), so that the check steps and the warm-up end
just before the densify and the window's first unit carries it: every run
holds it, and the window measures the densified state, as most of the
recipe's 800 steps do.

The check: the reference follows the check steps from the same inputs.
The densify inside the window acts on the program's own state, so it is
checked apart: the unit that carries it keeps the state it starts from,
and after the window the reference's densify runs on that same state; the
two results are compared exactly (`densify`: the active count and every
leaf's norm over the active rows, Adam's moments included)."""

from __future__ import annotations

import torch

from .. import compare, flops, inputs, stack


def _setup(root: str, cfg: dict, p: dict, seed: int, device):
    pkg = stack.package(root)
    lp = stack.lpips(pkg, cfg, seed, device)
    ts = pkg.stage1.init_train_state(stack.avatar(pkg, cfg, seed, device))
    s3 = pkg.stage3.Stage3Config(height=p["resolution"],
                                 width=p["resolution"], **cfg["stage3"])
    o = cfg["orbit"]
    orbit = pkg.sampler.refine_orbit_batch(
        o["views"], o["elevation_deg"], o["distance"], o["fovy_deg"],
        p["resolution"], p["resolution"], device=device)
    targets = inputs.images(seed, "targets", cfg["targets"], device)
    gen = inputs.generator(seed, "steps", device)
    ids = pkg.stage3.draw_view_ids(gen, o["views"], s3.train_bs,
                                   s3.max_steps, device)
    noise = torch.randn((2, ts.gaussians.capacity, 3), generator=gen,
                        device=device)
    fn = pkg.stage3.make_stage3_step(
        s3, pkg.render.RenderConfig(d_max=p["d_max"]), pkg.adam.AdamHyper(),
        orbit, targets, lp)
    return pkg, s3, fn, ids, noise, ts._replace(step=p["start_step"])


def _drive(root: str, cfg: dict, p: dict, seed: int, device, fault=None):
    """(unit-step(ts) -> (ts, metrics), ts after the check steps,
    readings, setup) ; `fault` "half_batch" trains each step on half of
    its views."""
    pkg, s3, fn, ids, noise, ts = setup = _setup(root, cfg, p, seed, device)

    def step(ts, on_densify=None):
        i = ts.step
        v = ids[i] if fault is None else ids[i][:s3.train_bs // 2]
        ts, m = fn(ts, v)
        if i == s3.densify_step:
            if on_densify is not None:
                on_densify(ts)
            ts, _ = pkg.stage3.densify(ts, s3, noise)
        return ts, m

    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    ts, readings = compare.train_readings(
        step, ts, p["check_steps"], pkg.adam.AdamHyper().beta1,
        pkg.gaussians.PARAM_FIELDS)
    return step, ts, readings, setup


def densify_readings(pkg, ts) -> list:
    """The active count, then each leaf's norm over the active rows, of the
    parameters and of Adam's moments."""
    n = ts.gaussians.n_active
    out = [float(n)]
    for f in pkg.gaussians.PARAM_FIELDS:
        for t in (getattr(ts.gaussians, f), ts.opt.m[f], ts.opt.v[f]):
            out.append(float(torch.linalg.vector_norm(t[:n].double())))
    return out


def _copy(pkg, ts):
    g = ts.gaussians
    clone = lambda d: {k: v.clone() for k, v in d.items()}
    return {"params": {f: getattr(g, f).clone()
                       for f in pkg.gaussians.PARAM_FIELDS},
            "n_active": g.n_active, "sh": (g.max_sh_degree,
                                           g.active_sh_degree),
            "m": clone(ts.opt.m), "v": clone(ts.opt.v),
            "count": ts.opt.count, "stats": {k: getattr(ts.stats, k).clone() for k in (
                "xyz_grad_accum", "denom", "max_radii2d")},
            "step": ts.step, "noise": None}


def _rebuild(pkg, snap):
    g = pkg.gaussians.GaussianState(**snap["params"],
                                    n_active=snap["n_active"],
                                    max_sh_degree=snap["sh"][0],
                                    active_sh_degree=snap["sh"][1])
    return pkg.stage1.TrainState(
        g, pkg.adam.AdamState(m=snap["m"], v=snap["v"],
                              count=snap["count"]),
        pkg.densify.DensifyStats(**snap["stats"]), snap["step"])


class Entry:
    def __init__(self, run):
        import gaussianip_tpu_torch as gt

        gt.set_precision_policy()  # the port's: TF32 off, as its CLI runs
        self.run = run
        p = run.params
        self.step, self.ts, self.readings, setup = _drive(
            stack.PROGRAM, run.cfg, p, run.seed, run.device)
        self.pkg, self.s3, self.noise = setup[0], setup[1], setup[4]
        self.before = self.after = None
        for _ in range(p["warmup_steps"]):
            self.unit()

    def unit(self):
        if self.ts.step == self.s3.densify_step:
            self.ts, _ = self.step(self.ts, self._keep)
            self.after = densify_readings(self.pkg, self.ts)
        else:
            self.ts, _ = self.step(self.ts)

    def _keep(self, ts):
        self.before = _copy(self.pkg, ts)
        self.before["noise"] = self.noise

    def end_to_end(self, wall_s: float, units: int) -> dict:
        return {"stage3_step_ms": wall_s / units * 1e3}

    def work(self) -> dict:
        cfg, p = self.run.cfg, self.run.params
        t = cfg["targets"]
        return {"flops": {cfg["precision"]: flops.lpips(
            cfg, 2 * cfg["stage3"]["train_bs"], t[1], t[2], True)}}

    def close(self):
        self.step = self.ts = None

    def unchanged_densify(self) -> float:
        """The `densify` reading of a densify that leaves the state as it
        was (a fault; the upper reading of that number)."""
        pkg = stack.package(stack.REFERENCE)
        kept = densify_readings(pkg, _rebuild(pkg, self.before))
        return densify_gap(self.before, kept, self.s3)

    def check(self) -> tuple:
        ref = reference_readings(self.run)
        gaps = compare.gaps(self.readings, ref)
        gaps["densify"] = densify_gap(self.before, self.after, self.s3)
        return self.readings, ref, gaps


def _ref_densify(before, s3) -> list:
    pkg = stack.package(stack.REFERENCE)
    cfg = pkg.stage3.Stage3Config(**{k: getattr(s3, k) for k in (
        "max_grad", "densify_min_opacity", "densify_world_size_threshold",
        "cameras_extent")})
    ts, _ = pkg.stage3.densify(_rebuild(pkg, before), cfg, before["noise"])
    return densify_readings(pkg, ts)


def densify_gap(before, after, s3) -> float:
    """The reference's densify on the program's own pre-densify state
    against the program's result: the largest relative gap of the
    readings (inf when the window never reached the densify)."""
    if before is None:
        return float("inf")
    ref = _ref_densify(before, s3)
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(after, ref))


def reference_readings(run, quant=None, fault=None) -> dict:
    """The reference's readings of the check steps; `quant` "tf32" for the
    control (float32 matmuls and convs on TF32), `fault` as _drive."""
    tf32 = quant == "tf32"
    if quant not in (None, "tf32"):
        raise ValueError(f"unknown control {quant!r}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _drive(stack.REFERENCE, run.cfg, run.params, run.seed,
                      run.device, fault)[2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


counters = stack.program_counters
gaps = compare.gaps
FAULTS = ("half_batch",)
