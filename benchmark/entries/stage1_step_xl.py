"""Entry `stage1_step_xl`: entry stage1_step's guided stage-1 step on the
SDXL stack (benchmark/stack_xl.py): the same unit, set-up, window and
check, with the port's UNet and ControlNet at SDXL's widths, the VAE
encode at the configuration's image_size and each CFG row's pooled text
and time ids. The reference's step is the plain SDXL stack's
(reference/gip_ref/diffusion/unet_xl.py, guidance/ipa_xl.py), whose VAE
encode recomputes its activations in the backward (ipa_xl's docstring) so
that it fits on the card beside its float32 weights."""

from __future__ import annotations

import torch

from .. import compare, flops_xl, inputs, stack, stack_xl
from . import stage1_step


def _drive(root: str, cfg: dict, p: dict, seed: int, device, dtype,
           fault=None):
    """(step(ts) -> (ts, metrics), ts after the check steps, readings)."""
    pkg = stack_xl.package(root)
    models = stack.diffusion_models(pkg, cfg, seed, device, dtype)
    guid = stack_xl.guidance(pkg, cfg, models, seed, device)
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
        """Operations per unit by precision, K3's share and the
        transformer blocks' share of them."""
        cfg, p = self.run.cfg, self.run.params
        size = cfg["guidance"]["image_size"]
        lat = size // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        call = flops_xl.denoise_call(cfg, p["cfg_batch"], lat)
        vae = flops_xl.vae_encode(cfg, p["views"], size, True)
        return {"flops": {cfg["precision"]: call["flops"] + vae},
                "transformer_flops": call["transformer_flops"],
                "k3": {"flops": call["k3_flops"], "bytes": call["k3_bytes"],
                       "launches": call["k3_sites"]}}

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
