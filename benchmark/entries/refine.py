"""Entry `refine`: the stage-2 VCR refinement of the port
(system/refine.py:refine_views). A unit is one refine of the 32 orbit
views at 1024^2: the VAE encode, 8 of the 50 DDIM steps, each of
ControlNet + UNet calls on the CFG-doubled batch with the up blocks'
mutual attention (anchors `store`, keys `key`, dense views `dense` in
groups of `dense_batch`), and the VAE decode. The views, pose maps,
[2, 81, 768] contexts and the shared noise come from the seed; the
refine's cost does not depend on their content.

Set-up warms up every shape with a one-step refine. The check: once the
window has closed, the plain reference refines the same inputs in float32,
for the anchors, the keys and one dense group drawn from the seed (the
dense groups do not feed each other nor the anchors and keys), and the
program's last refine is held against it on those views (`rms`: the
largest, over the views, of the root mean square of a view's pixel
gap)."""

from __future__ import annotations

import torch

from .. import flops, inputs, stack


def refine_inputs(pkg, cfg: dict, p: dict, seed: int, device) -> tuple:
    """(images, pose maps, contexts, noise) from the seed."""
    n, side = p["views"], p["resolution"]
    c = cfg["conditioning"]
    tokens = c["text_tokens"] + cfg["unet"]["ip_tokens"]
    gen = inputs.generator(seed, "contexts", device)
    contexts = {name: torch.randn((2, tokens, c["context_dim"]),
                                  generator=gen, device=device)
                for name in pkg.refine.VIEW_NAME_ALL}
    lat = side // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    noise = torch.randn((cfg["vae"]["latent_channels"], lat, lat),
                        generator=gen, device=device)
    return (inputs.images(seed, "views", (n, side, side, 3), device),
            inputs.images(seed, "poses", (n, side, side, 3), device),
            contexts, noise)


def _kwargs(p: dict) -> dict:
    return {k: p[k] for k in ("num_steps", "num_ladder", "guidance_scale",
                              "ip_scale", "lambda_self", "dense_batch")}


def sampled_group(seed: int, p: dict) -> int:
    """The dense group (an index of refine.dense_groups) that the check
    compares, drawn from the seed."""
    n_groups = -(-24 // p["dense_batch"])
    return inputs.sub_seed(seed, "sample") % n_groups


def _refine(root, cfg, p, seed, device, dtype):
    pkg = stack.package(root)
    models = pkg.refine.RefineModels(*stack.diffusion_models(
        pkg, cfg, seed, device, dtype))
    return pkg, models, refine_inputs(pkg, cfg, p, seed, device)


class Entry:
    def __init__(self, run):
        import gaussianip_tpu_torch as gt

        gt.set_precision_policy()  # the port's: TF32 off, as its CLI runs
        self.run = run
        p = run.params
        self.pkg, self.models, self.inputs = _refine(
            stack.PROGRAM, run.cfg, p, run.seed, run.device,
            stack.DTYPES[run.cfg["precision"]])
        self.cuda = torch.device(run.device).type == "cuda"
        self.phases = []
        self.out = None
        self.pkg.refine.refine_views(self.models, *self.inputs,
                                     **{**_kwargs(p), "num_steps": 1})

    def _note(self, name):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.phases[-1].append((name, e))

    def unit(self):
        if self.cuda:
            self.phases = self.phases[-1:]
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.phases.append([("start", start)])
        self.out = self.pkg.refine.refine_views(
            self.models, *self.inputs, on_phase=self._note,
            **_kwargs(self.run.params))

    def vae_s(self):
        """The VAE encode's and decode's device seconds in the last
        refine (CUDA events at refine_views' phase hooks)."""
        if not self.phases:
            return None
        torch.cuda.synchronize()
        ev = self.phases[-1]
        names = [n for n, _ in ev]
        enc = ev[0][1].elapsed_time(ev[names.index("encode")][1])
        last = max(i for i, n in enumerate(names) if n == "dense")
        dec = ev[last][1].elapsed_time(ev[names.index("decode")][1])
        return (enc + dec) * 1e-3

    def end_to_end(self, wall_s: float, units: int) -> dict:
        return {"refine_s": wall_s / units}

    def work(self) -> dict:
        cfg, p = self.run.cfg, self.run.params
        call = flops.refine(cfg, p)
        return {"flops": {cfg["precision"]: call["flops"]},
                "k3": {"flops": call["k3_flops"], "bytes": call["k3_bytes"],
                       "launches": call["k3_sites"]}}

    def close(self):
        self.out = self.out.detach().to("cpu") if self.out is not None \
            else None
        self.models = self.inputs = None

    def check(self) -> tuple:
        ref, views = reference_views(self.run)
        got = self.out.to(ref.device)[views]
        return got, ref, gaps(got, ref)


def rms(a, b) -> float:
    """The largest per-view root mean square gap of [N, H, W, 3] views."""
    d = (a.double() - b.double()) ** 2
    return float(torch.sqrt(d.flatten(1).mean(dim=1)).max())


def gaps(got, ref) -> dict:
    return {"rms": rms(got, ref)}


def reference_readings(run, quant=None, fault=None):
    """The reference's refined views of the sample (the control's with
    `quant` "fp8")."""
    if fault is not None:
        raise ValueError(f"no planted fault {fault!r} for the refine")
    return reference_views(run, quant)[0]


FAULTS = ()


def reference_views(run, quant=None) -> tuple:
    """(the reference's refined views of the sample, their indices);
    `quant` "fp8" for the control."""
    from ..reference.gip_ref import lowp

    p = run.params
    g = sampled_group(run.seed, p)
    with lowp.quantised(quant):
        pkg, models, ins = _refine(stack.REFERENCE, run.cfg, p, run.seed,
                                   run.device, torch.float32)
        out = pkg.refine.refine_views(models, *ins, dense_only=[g],
                                      **_kwargs(p))
    names = (pkg.refine.ANCHOR_NAMES + pkg.refine.KEY_NAMES
             + pkg.refine.dense_groups(p["dense_batch"])[g][1])
    views = sorted(pkg.refine.view_index(n) for n in names)
    return out[views], views


counters = stack.program_counters
