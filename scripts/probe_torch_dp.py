"""Three probes of chip_smoke.py's data-parallel phase (dp) on one card,
for the PyTorch port; it imports no JAX:

    python3 scripts/probe_torch_dp.py [planted] [refine] [components]

(all three without arguments). Two gloo ranks on cuda:0 through
gaussianip_tpu_torch.parallel.spawn, on chip_smoke.py's scene (100k
points):

planted: chip_smoke.dp_stage1_f32 (two ranks' f32 stage-1 steps against
   one process, the batch's depth max in the last rank's views) as the
   port runs it, and with the depth max of system/stage1.py replaced by
   (a) each rank's own max, (b) the global max's value with its gradient
   given to every rank's own argmax. The check must pass the port and fail
   both faults.
refine: the same single-process refine_views (32 views at 1024^2, one
   denoise step, dense groups of 4) in both ranks: each alone while the
   other waits, then both at once: as the port runs, with cuDNN off, with
   K3 replaced by its plain version, and with each process's memory capped
   at a share of the card; then rank 0 alone with its memory capped below
   the refine's own peak. Each result is held against the other rank's
   and against the rank's own first result: max |diff| and the views that
   differ, with each variant's peak reserved memory.
components: the refine's parts on the same inputs (see `components`),
   each as the port runs it and with one thing changed, held across the
   ranks: which part, and which change, makes two processes differ.

Prints one JSON line per result; exits 1 when a planted fault passes the
check or the port fails it.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the capped variants' share of the card's memory: each of two processes
# at once, and rank 0 alone (of the refine's own peak)
SHARE_TOGETHER = 0.45
SHARE_OF_PEAK_ALONE = 0.8


def _local_argmax_grad(group, x):
    """Fault (b): the global max's value, its gradient to the rank's own
    argmax."""
    from gaussianip_tpu_torch.parallel.mesh import all_max

    m = x.max()
    return m if group is None else m + (all_max(group, m.detach())
                                        - m.detach())


def _faults():
    from gaussianip_tpu_torch.parallel import mesh

    return {"port": mesh.global_max,
            "rank_local_max": lambda group, x: x.max(),
            "grad_to_local_argmax": _local_argmax_grad}


def planted(group, gs, points3d) -> dict:
    from gaussianip_tpu_torch.parallel import mesh
    from gaussianip_tpu_torch.system import stage1

    out = {}
    for name, fn in _faults().items():
        print(f"[probe:planted] {name}", flush=True)
        stage1.global_max = fn
        try:
            cs.dp_stage1_f32(group, gs, points3d)
            out[name] = "passed"
        except AssertionError as e:  # raised in rank 0 alone
            out[name] = f"failed: {e}"
        finally:
            stage1.global_max = mesh.global_max
        mesh.barrier(group)
    return out


def refine_spread(group, gs, points3d) -> dict:
    import torch
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.ops import conv3x3 as c3
    from gaussianip_tpu_torch.ops.conv3x3_cuda import conv3x3_plain
    from gaussianip_tpu_torch.parallel.mesh import (all_max, barrier,
                                                    replicated)
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system.refine import (refine_views,
                                                    render_refine_views)

    dev = str(group.device)
    guidance = pl.build_random_sd15_guidance(seed=cs.SEED, device=dev)
    models = pl.refine_models(guidance)
    contexts = pl.random_refine_contexts(cs.SEED, dev)
    orbit = refine_orbit_batch(cs.REFINE_VIEWS, 17.0, 1.5, 70.0, cs.HIRES,
                               cs.HIRES, device=dev)
    images, poses = replicated(group, render_refine_views(
        gs, orbit, points3d, cs.HIRES, cs.HIRES, RenderConfig(
            d_max=cs.D_MAX)))
    side = cs.HIRES // models.vae.cfg.downscale
    noise = torch.randn((4, side, side), device=dev, generator=torch.Generator(
        device=dev).manual_seed(cs.SEED))
    total = torch.cuda.get_device_properties(dev).total_memory

    def run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = refine_views(models, images, poses, contexts, noise,
                         num_steps=1, dense_batch=4)
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0, torch.cuda.max_memory_reserved()

    def diff(a, b):
        d = (a - b).abs().flatten(1).amax(1)
        return {"max_abs": float(d.max()), "views": int((d > 0).sum())}

    out, base = {}, None

    def record(name, y, secs, peak, alone_rank=None):
        # rank 0's y against every rank's; the rank's own first result
        r0 = replicated(group, y) if alone_rank is None else None
        res = {"seconds": round(secs, 3), "peak_reserved_gib":
               round(peak / 2 ** 30, 3)}
        if r0 is not None:
            res["across_ranks_max_abs"] = float(all_max(
                group, (y - r0).abs().max()))
        if base is not None and y is not None:
            res["against_own_alone"] = diff(y, base)
        out[name] = res
        print(f"[probe:refine] rank {group.rank} {name} "
              f"{json.dumps(res)}", flush=True)

    def together(name):
        barrier(group)
        y, secs, peak = run()
        record(name, y, secs, peak)

    # each alone while the other waits
    ys = {}
    for r in range(group.world_size):
        barrier(group)
        if group.rank == r:
            ys[r] = run()
    barrier(group)
    y, secs, peak = ys[group.rank]
    base = y
    record("alone", y, secs, peak)
    together("together")
    torch.backends.cudnn.enabled = False
    together("together_no_cudnn")
    torch.backends.cudnn.enabled = True
    same = c3.conv3x3_same
    c3.conv3x3_same = lambda x, w, b=None: conv3x3_plain(x, w.to(x.dtype), b)
    together("together_k3_plain")
    c3.conv3x3_same = same
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(SHARE_TOGETHER, dev)
    together("together_capped")
    # rank 0 alone, capped below its own peak
    torch.cuda.empty_cache()
    barrier(group)
    if group.rank == 0:
        torch.cuda.set_per_process_memory_fraction(
            min(1.0, SHARE_OF_PEAK_ALONE * peak / total), dev)
        try:
            y, secs, p = run()
            record("alone_capped", y, secs, p, alone_rank=0)
        except torch.cuda.OutOfMemoryError as e:
            out["alone_capped"] = f"out of memory: {str(e)[:200]}"
    barrier(group)
    torch.cuda.set_per_process_memory_fraction(1.0, dev)
    return out


def components(group, gs, points3d) -> dict:
    """The refine's parts on the same inputs in both ranks at once: the
    inputs' and weights' digests held across the ranks, then the VAE encode
    of 8 handoff views, their decode, and one anchors call of the UNet
    (store mode, CFG batch 8), each as the port runs it and with one thing
    changed: cuDNN off, K3 on its plain version, both, attention on one
    fused backend (flash, memory-efficient), and every new CUDA tensor
    filled with NaN (torch.utils.deterministic.fill_uninitialized_memory).
    For each: max |diff| across the ranks, and against the rank's own
    result as the port runs it."""
    import contextlib

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from gaussianip_tpu_torch.data.sampler import refine_orbit_batch
    from gaussianip_tpu_torch.diffusion.scheduler import make_ddim_schedule
    from gaussianip_tpu_torch.ops import conv3x3 as c3
    from gaussianip_tpu_torch.ops.conv3x3_cuda import conv3x3_plain
    from gaussianip_tpu_torch.parallel.mesh import (all_max,
                                                    check_replicated,
                                                    replicated)
    from gaussianip_tpu_torch.render.render import RenderConfig
    from gaussianip_tpu_torch.system import pipeline as pl
    from gaussianip_tpu_torch.system.refine import (make_refine_step,
                                                    render_refine_views,
                                                    vae_decode, vae_encode)

    dev = str(group.device)
    guidance = pl.build_random_sd15_guidance(seed=cs.SEED, device=dev)
    models = pl.refine_models(guidance)
    contexts = pl.random_refine_contexts(cs.SEED, dev)
    orbit = refine_orbit_batch(cs.REFINE_VIEWS, 17.0, 1.5, 70.0, cs.HIRES,
                               cs.HIRES, device=dev)
    images, poses = render_refine_views(gs, orbit, points3d, cs.HIRES,
                                        cs.HIRES, RenderConfig(
                                            d_max=cs.D_MAX))
    out = {}
    try:
        check_replicated(group, {
            "unet": models.unet.state_dict(),
            "controlnet": models.controlnet.state_dict(),
            "vae": models.vae.state_dict(), "contexts": contexts,
            "images": images, "poses": poses}, "inputs")
        out["inputs"] = "equal"
    except RuntimeError as e:
        out["inputs"] = str(e)[:2000]
    print(f"[probe:components] rank {group.rank} inputs {out['inputs']}",
          flush=True)
    images, poses = replicated(group, (images, poses))
    lat0 = replicated(group, vae_encode(models.vae, images[:8]))
    run = make_refine_step(models, make_ddim_schedule(device=dev), 7.5, 0.6)
    lat, ctx, ctrl = cs.refine_call_inputs(
        models, contexts, images, poses,
        torch.Generator(device=dev).manual_seed(cs.SEED))
    parts = {"encode": lambda: vae_encode(models.vae, images[:8]),
             "decode": lambda: vae_decode(models.vae, lat0),
             "unet_store": lambda: run(lat, 143, 122, ctx, ctrl,
                                       "store")[0]}
    same = c3.conv3x3_same
    plain = lambda x, w, b=None: conv3x3_plain(x, w.to(x.dtype), b)

    @contextlib.contextmanager
    def variant(name):
        det = torch.utils.deterministic
        if name in ("no_cudnn", "both_off"):
            torch.backends.cudnn.enabled = False
        if name in ("k3_plain", "both_off"):
            c3.conv3x3_same = plain
        if name == "nan_fill":
            torch.use_deterministic_algorithms(True, warn_only=True)
            det.fill_uninitialized_memory = True
        backend = {"sdpa_flash": [SDPBackend.FLASH_ATTENTION],
                   "sdpa_efficient": [SDPBackend.EFFICIENT_ATTENTION]}.get(
            name)
        try:
            with sdpa_kernel(backend) if backend else \
                    contextlib.nullcontext():
                yield
        finally:
            torch.backends.cudnn.enabled = True
            c3.conv3x3_same = same
            torch.use_deterministic_algorithms(False)

    base = {}
    for name in ("port", "no_cudnn", "k3_plain", "both_off", "sdpa_flash",
                 "sdpa_efficient", "nan_fill", "port_again"):
        for part, fn in parts.items():
            try:
                with variant(name):
                    y = fn()
                    torch.cuda.synchronize()
                err = None
            except RuntimeError as e:  # a backend that refuses the shapes
                y, err = None, str(e)[:200]
            # every rank reaches the same collectives: a refusal is the
            # same on both
            if y is None:
                res = {"error": err}
            else:
                res = {"across_ranks_max_abs": float(all_max(
                    group, (y - replicated(group, y)).abs().max())),
                    "finite": bool(torch.isfinite(y).all())}
                if name == "port":
                    base[part] = y
                else:
                    res["against_own_port"] = float(
                        (y - base[part]).abs().max())
            out[f"{name}:{part}"] = res
            print(f"[probe:components] rank {group.rank} {name}:{part} "
                  f"{json.dumps(res)}", flush=True)
    return out


def probe_rank(group, scene_path: str, points3d, parts):
    import torch
    from gaussianip_tpu_torch import set_precision_policy
    from gaussianip_tpu_torch.model.gaussians import GaussianState
    from gaussianip_tpu_torch.parallel.mesh import replicated

    set_precision_policy()
    dev = str(group.device)
    gs = replicated(group, GaussianState(**{
        k: v.to(dev) if isinstance(v, torch.Tensor) else v
        for k, v in torch.load(scene_path).items()}))
    fns = {"planted": planted, "refine": refine_spread,
           "components": components}
    return {p: fns[p](group, gs, points3d) for p in parts}


def main(argv) -> int:
    import tempfile

    import torch
    from gaussianip_tpu_torch import _nvcc, set_precision_policy
    from gaussianip_tpu_torch.parallel.mesh import spawn

    parts = argv or ["planted", "refine", "components"]
    if not torch.cuda.is_available():
        print("probe_torch_dp: no CUDA device", file=sys.stderr)
        return 1
    set_precision_policy()
    print(cs.smi_line(), flush=True)
    _nvcc.build(["composite", "conv3x3"])
    sk, gs = cs.build_scene("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.pt")
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in vars(gs).items()}, path)
        res = spawn(2, probe_rank, path, np.asarray(sk.points3d), parts,
                    backend="gloo", devices=["cuda:0"] * 2)
    print(json.dumps({p: [r[p] for r in res] for p in parts}), flush=True)
    planted_ = res[0].get("planted", {})
    ok = planted_.get("port", "passed") == "passed" and all(
        v.startswith("failed") for k, v in planted_.items() if k != "port")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
