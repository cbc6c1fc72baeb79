"""Entry `stage1_step`: the guided stage-1 training step of the port
(system/stage1.py:make_train_step), run back to back on one training
state. A unit is one step: cameras and draws from the step generator, the
render (K1 / K2), the VAE encode forward and backward, ControlNet + UNet on
the 3-way CFG batch (K3), the ANPG loss and Adam. The window holds no
densify or prune step (the recipe's first densify is at step 500).

Set-up builds the state from the seed's avatar, drives it through the
workload's `check_steps` by the window's own call (the readings that the
reference follows) and `warmup_steps` more, then hands it to the window.
The check rebuilds the same inputs in the plain reference in float32 and
runs the same steps."""

from __future__ import annotations

import torch

from .. import compare, flops, inputs, stack


def _make_step(pkg, cfg: dict, p: dict, guid, fault=None):
    """The step `fn(ts, generator)`; with `fault` "half_batch", one that
    draws the whole batch and trains on its first half, the loss a mean
    over it (a fault the check has to catch)."""
    res = p["resolution"]
    args = (pkg.stage1.Stage1Config(render_height=res, render_width=res),
            pkg.sampler.CameraSamplerConfig(height=res, width=res,
                                            batch_size=p["views"]),
            pkg.render.RenderConfig(d_max=p["d_max"]),
            pkg.adam.AdamHyper(), guid, inputs.keypoints("cpu").numpy())
    if fault is None:
        return pkg.stage1.make_train_step(*args)
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    inner = pkg.stage1.make_inner_step(*args)
    cam = args[1]
    shape = (cam.batch_size, res, res, 3)
    h = cam.batch_size // 2

    def half(ts, gen):
        dev = ts.gaussians.device
        batch = pkg.stage1.sample_train_batch(cam, gen, ts.step, dev)
        draws = guid.sample_noise(gen, shape, dev)
        return inner(ts, type(batch)(*(x[:h] for x in batch)),
                     {k: v[:h] for k, v in draws.items()})

    return half


def _drive(root: str, cfg: dict, p: dict, seed: int, device, dtype,
           fault=None):
    """(step(ts) -> (ts, metrics), ts after the check steps, readings)."""
    pkg = stack.package(root)
    models = stack.diffusion_models(pkg, cfg, seed, device, dtype)
    guid = stack.guidance(pkg, cfg, models, seed, device)
    ts = pkg.stage1.init_train_state(stack.avatar(pkg, cfg, seed, device))
    fn = _make_step(pkg, cfg, p, guid, fault)
    gen = inputs.generator(seed, "steps", device)
    step = lambda ts: fn(ts, gen)
    ts, readings = compare.train_readings(
        step, ts, p["check_steps"], pkg.adam.AdamHyper().beta1,
        pkg.gaussians.PARAM_FIELDS)
    return step, ts, readings


class Entry:
    def __init__(self, run):
        import gaussianip_tpu_torch as gt

        gt.set_precision_policy()  # the port's: TF32 off, as its CLI runs
        self.run = run
        cfg, p = run.cfg, run.params
        self.step, self.ts, self.readings = _drive(
            stack.PROGRAM, cfg, p, run.seed, run.device,
            stack.DTYPES[cfg["precision"]])
        for _ in range(p["warmup_steps"]):
            self.unit()

    def unit(self):
        self.ts, _ = self.step(self.ts)

    def end_to_end(self, wall_s: float, units: int) -> dict:
        return {"stage1_step_ms": wall_s / units * 1e3}

    def work(self) -> dict:
        """Operations per unit by precision, and K3's share of them."""
        cfg, p = self.run.cfg, self.run.params
        lat = cfg["guidance"]["image_size"] // 2 ** (
            len(cfg["vae"]["block_out_channels"]) - 1)
        call = flops.denoise_call(cfg, p["cfg_batch"], lat)
        vae = flops.vae_encode(cfg, p["views"],
                               cfg["guidance"]["image_size"], True)
        return {"flops": {cfg["precision"]: call["flops"] + vae},
                "k3": {"flops": call["k3_flops"], "bytes": call["k3_bytes"],
                       "launches": call["k3_sites"]}}

    def close(self):
        self.step = self.ts = None

    def check(self) -> tuple:
        """(program's readings, reference's readings, the compared gaps)."""
        ref = reference_readings(self.run)
        return self.readings, ref, compare.gaps(self.readings, ref)


def reference_readings(run, quant=None, fault=None) -> dict:
    """The plain reference's readings of the run's check steps; `quant`
    "fp8" for the control, `fault` as _make_step takes it."""
    from ..reference.gip_ref import lowp

    with lowp.quantised(quant):
        return _drive(stack.REFERENCE, run.cfg, run.params, run.seed,
                      run.device, torch.float32, fault)[2]


counters = stack.program_counters
gaps = compare.gaps
FAULTS = ("half_batch",)
