"""Entry `stage1_step_flux`: entry stage1_step's guided stage-1 step on
the FLUX.1-dev stack (benchmark/stack_flux.py): the same unit, set-up,
window and check, with the port's FLUX transformer (IP identity
attention) and Union ControlNet as a velocity prior, the pose maps
encoded through the 16-channel VAE each step, and the VAE encode at the
configuration's image_size. The reference's step is the plain FLUX
stack's (reference/gip_ref/diffusion/flux.py, guidance/ipa_flux.py),
which recomputes the VAE encode in the backward and runs each CFG row
alone (ipa_flux's docstring), so that it fits on the card beside its
float32 weights."""

from __future__ import annotations

import torch

from .. import compare, flops_flux, inputs, stack, stack_flux
from . import stage1_step


def _drive(root: str, cfg: dict, p: dict, seed: int, device, dtype,
           fault=None):
    """(step(ts) -> (ts, metrics), ts after the check steps, readings)."""
    pkg = stack_flux.package(root)
    models = stack_flux.diffusion_models(pkg, cfg, seed, device, dtype)
    guid = stack_flux.guidance(pkg, cfg, models, seed, device)
    ts = pkg.stage1.init_train_state(stack.avatar(pkg, cfg, seed, device))
    fn = stage1_step._make_step(pkg, cfg, p, guid, fault)
    gen = inputs.generator(seed, "steps", device)
    step = lambda ts: fn(ts, gen)
    ts, readings = compare.train_readings(
        step, ts, p["check_steps"], pkg.adam.AdamHyper().beta1,
        pkg.gaussians.PARAM_FIELDS)
    return step, ts, readings


class Entry(stage1_step.Entry):
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

    def work(self) -> dict:
        """Operations per unit by precision (the denoise call, the VAE
        encode forward and backward, the pose maps' encode), and the
        double- and single-stream blocks' shares."""
        cfg, p = self.run.cfg, self.run.params
        size = cfg["guidance"]["image_size"]
        lat = size // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        call = flops_flux.denoise_call(cfg, p["cfg_batch"], lat)
        vae = flops_flux.vae_encode(cfg, p["views"], size, True)
        pose = flops_flux.vae_encode(cfg, p["views"], size)
        return {"flops": {cfg["precision"]: call["flops"] + vae + pose},
                "double_flops": call["double_flops"],
                "single_flops": call["single_flops"]}

    def check(self) -> tuple:
        """(program's readings, reference's readings, the compared gaps)."""
        ref = reference_readings(self.run)
        return self.readings, ref, compare.gaps(self.readings, ref)


def reference_readings(run, quant=None, fault=None) -> dict:
    """The plain reference's readings of the run's check steps; `quant`
    "fp8" for the control, `fault` as stage1_step._make_step takes it."""
    from ..reference.gip_ref import lowp

    with lowp.quantised(quant):
        return _drive(stack.REFERENCE, run.cfg, run.params, run.seed,
                      run.device, torch.float32, fault)[2]


counters = stack.program_counters
gaps = compare.gaps
FAULTS = stage1_step.FAULTS
