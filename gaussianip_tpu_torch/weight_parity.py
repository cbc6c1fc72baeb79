"""Released-checkpoint weight-parity harness (port of
scripts/weight_parity.py), one command once the weights exist.

1) record (on a machine with `diffusers` and the released checkpoints):
     python -m gaussianip_tpu_torch.weight_parity record --out ref.npz \
       --unet <Realistic_Vision_V4.0_noVAE/unet> --vae <sd-vae-ft-mse> \
       --controlnet <control_v11p_sd15_openpose>
   Runs the diffusers models on fixed seeded inputs (`fixed_inputs`) and
   saves the inputs and outputs (NHWC, float32) under the keys unet_out,
   vae_mean, vae_dec, cn_res_{i} and cn_mid. The same recording serves
   this command and the JAX package's scripts/weight_parity.py.

2) compare:
     python -m gaussianip_tpu_torch.weight_parity compare --ref ref.npz \
       --unet <unet/diffusion_pytorch_model.safetensors> [--ipa <bin>] \
       --vae <...> --controlnet <...> [--device cuda|cpu]
   Loads each checkpoint through the port's converters
   (diffusion/weights.py: load_torch_state_dict, convert_*, then the flax
   tree into the module as the real-weights path does,
   system/pipeline.py:load_flax_tree), runs the modules on the recorded
   inputs (NHWC at the edges, NCHW inside) and checks every recorded
   output. Exit 1 on any failure.

Precision. Each model computes in float32 where it can, and each output
of a float32 model is held to a max |diff| of 5e-3, the JAX script's
check. On the card that holds for the VAE (its convolutions are F.conv2d),
not for the UNet and the ControlNet: float32 reaches K3 there (every
stride-1 3x3 conv of their ResnetBlocks and Upsamples goes to
ops/conv3x3_cuda.py, 47 in the UNet and 20 in the ControlNet), and K3
takes bfloat16 only, so a float32 UNet on the card raises at its first
such conv. On the card they compute in bfloat16, and a bfloat16 output is
held to 6e-2 of the recording's largest |value| (the repository's
bfloat16-against-float32 tolerance for whole stacks; a converter's layout
fault is O(1)). The kernels' launches are printed at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

import numpy as np
import torch

SEED = 1234
LAT = (2, 64, 64, 4)  # NHWC latents
IMG = (1, 256, 256, 3)
CTX = (2, 77, 768)
TS = np.array([17, 901], np.int64)
TOL = 5e-3  # float32: max |diff|
BF16_REL_TOL = 6e-2  # bfloat16: max |diff| over the recording's max |value|
CN_EMBED = (16, 32, 96, 256)  # control_v11p_sd15_openpose's cond embedding


def fixed_inputs():
    rng = np.random.default_rng(SEED)
    return {
        "lat": rng.normal(0, 1, LAT).astype(np.float32),
        "img": rng.normal(0, 0.5, IMG).astype(np.float32),
        "ctx": rng.normal(0, 1, CTX).astype(np.float32),
        "cond": rng.uniform(0, 1, (2, 512, 512, 3)).astype(np.float32),
        "ts": TS,
    }


def record(args):
    """The diffusers models on fixed_inputs() -> args.out (.npz)."""
    try:
        from diffusers import AutoencoderKL as AKL
        from diffusers import ControlNetModel as CN
        from diffusers import UNet2DConditionModel as UN
    except ImportError as e:
        raise ImportError("weight_parity record runs the released models "
                          "through the `diffusers` package, which is not "
                          "installed; record on a machine that has it") from e

    x = fixed_inputs()
    out = dict(x)
    with torch.no_grad():
        if args.unet:
            unet = UN.from_pretrained(args.unet).eval()
            r = unet(torch.from_numpy(x["lat"]).permute(0, 3, 1, 2),
                     torch.from_numpy(x["ts"]),
                     torch.from_numpy(x["ctx"])).sample
            out["unet_out"] = r.permute(0, 2, 3, 1).numpy()
        if args.vae:
            vae = AKL.from_pretrained(args.vae).eval()
            m = vae.encode(torch.from_numpy(x["img"]).permute(0, 3, 1, 2))
            out["vae_mean"] = (
                m.latent_dist.mean.permute(0, 2, 3, 1).numpy())
            d = vae.decode(torch.from_numpy(x["lat"][:1]).permute(0, 3, 1, 2))
            out["vae_dec"] = d.sample.permute(0, 2, 3, 1).numpy()
        if args.controlnet:
            cn = CN.from_pretrained(args.controlnet).eval()
            res, mid = cn(torch.from_numpy(x["lat"]).permute(0, 3, 1, 2),
                          torch.from_numpy(x["ts"]),
                          torch.from_numpy(x["ctx"]),
                          torch.from_numpy(x["cond"]).permute(0, 3, 1, 2),
                          return_dict=False)
            for i, r in enumerate(res):
                out[f"cn_res_{i}"] = r.permute(0, 2, 3, 1).numpy()
            out["cn_mid"] = mid.permute(0, 2, 3, 1).numpy()
    np.savez(args.out, **out)
    print(f"recorded -> {args.out}")


def outputs(x: dict, unet=None, vae=None, controlnet=None,
            device="cpu") -> dict:
    """The recorded outputs of the given port modules on inputs `x` (the
    NHWC arrays of fixed_inputs()) as NHWC float32 numpy arrays, each
    model as the JAX script runs it: the UNet without residuals, the VAE's
    posterior mean and its decode of the first latents (scaled), the
    ControlNet's residuals."""
    t = lambda k: torch.from_numpy(np.ascontiguousarray(x[k])).to(device)
    nchw = lambda k: t(k).permute(0, 3, 1, 2)
    nhwc = lambda y: y.float().permute(0, 2, 3, 1).cpu().numpy()
    out = {}
    with torch.no_grad():
        if unet is not None:
            out["unet_out"] = nhwc(unet(nchw("lat"), t("ts"), t("ctx")))
        if vae is not None:
            mean, _ = vae.encode_moments(nchw("img"))
            out["vae_mean"] = nhwc(mean)
            out["vae_dec"] = nhwc(vae.decode(
                nchw("lat")[:1] * vae.cfg.scaling_factor))
        if controlnet is not None:
            res, mid = controlnet(nchw("lat"), t("ts"), t("ctx"),
                                  nchw("cond"))
            for i, r in enumerate(res):
                out[f"cn_res_{i}"] = nhwc(r)
            out["cn_mid"] = nhwc(mid)
    return out


def published_configs(ipa: bool):
    """(UNet, VAE, ControlNet) configs at the published widths: the UNet
    with the IP-Adapter's rank-128 LoRA and 4 IP tokens when `ipa`."""
    from .diffusion.vae import VAEConfig
    from .system.pipeline import sd15_unet_config

    return (sd15_unet_config(128 if ipa else 0, 4 if ipa else 0,
                             torch.float32), VAEConfig(),
            sd15_unet_config(0, 0, torch.float32))


def compute_dtypes(device) -> dict:
    """Each model's compute dtype on `device` (see the module's
    docstring)."""
    k3 = torch.bfloat16 if device == "cuda" else torch.float32
    return {"unet": k3, "controlnet": k3, "vae": torch.float32}


def load_models(args, device, unet_cfg=None, vae_cfg=None, cn_cfg=None,
                cn_embed=CN_EMBED) -> dict:
    """The checkpoints that args name, loaded through the port's
    converters into its modules on `device`, at compute_dtypes(device)."""
    from .diffusion import weights as W
    from .diffusion.unet import ControlNetModel, UNet2DConditionModel
    from .diffusion.vae import AutoencoderKL
    from .system.pipeline import load_flax_tree

    dt = compute_dtypes(device)
    ucfg, vcfg, ccfg = published_configs(bool(args.ipa))
    ucfg = replace(unet_cfg or ucfg, dtype=dt["unet"])
    vcfg = replace(vae_cfg or vcfg, dtype=dt["vae"])
    ccfg = replace(cn_cfg or ccfg, dtype=dt["controlnet"])
    models = {}
    if args.unet:
        ipa = None
        if args.ipa:
            ipa = W.load_torch_state_dict(args.ipa)["ip_adapter"]
        tree = W.convert_unet(W.load_torch_state_dict(args.unet),
                              ucfg.block_out_channels, ucfg.layers_per_block,
                              ipa_state=ipa)
        models["unet"] = load_flax_tree(
            lambda: UNet2DConditionModel(ucfg), tree, device).eval()
    if args.vae:
        tree = W.convert_vae(W.load_torch_state_dict(args.vae),
                             vcfg.block_out_channels, vcfg.layers_per_block)
        models["vae"] = load_flax_tree(lambda: AutoencoderKL(vcfg), tree,
                                       device).eval()
    if args.controlnet:
        tree = W.convert_controlnet(W.load_torch_state_dict(args.controlnet),
                                    ccfg.block_out_channels,
                                    ccfg.layers_per_block, cn_embed)
        models["controlnet"] = load_flax_tree(
            lambda: ControlNetModel(ccfg, conditioning_embed_channels=(
                cn_embed)), tree, device).eval()
    return models


def compare(args, unet_cfg=None, vae_cfg=None, cn_cfg=None,
            cn_embed=CN_EMBED) -> int:
    """Check the loaded models against the recording; -> the number of
    outputs that failed. The configs default to the published widths."""
    import gaussianip_tpu_torch as gt

    from .kernels import count_launches
    from .launch import _check_args

    _check_args(args)
    gt.set_precision_policy()  # float32 is float32 on the card too
    device = args.device
    ref = dict(np.load(args.ref)) if args.ref else fixed_inputs()
    x = {k: ref[k] for k in ("lat", "img", "ctx", "cond", "ts")}
    models = load_models(args, device, unet_cfg, vae_cfg, cn_cfg, cn_embed)
    outs, launches = count_launches(
        lambda: outputs(x, device=device, **models), device)
    fails = 0
    for name, got in outs.items():
        if name not in ref:
            print(f"{name}: no recording, computed shape {got.shape}")
            continue
        err = float(np.max(np.abs(got - ref[name])))
        model = ("unet" if name == "unet_out" else "vae"
                 if name.startswith("vae") else "controlnet")
        if models[model].cfg.dtype == torch.float32:
            ok, note = err < TOL, ""
        else:
            scale = float(np.max(np.abs(ref[name])))
            ok = err < BF16_REL_TOL * scale
            note = f" (bfloat16, max |ref| {scale:.2e})"
        fails += 0 if ok else 1
        print(f"{name}: max_abs_err={err:.2e}{note} {'OK' if ok else 'FAIL'}")
    print("launches " + json.dumps(launches))
    return fails


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["record", "compare"])
    ap.add_argument("--out", default="weight_parity_ref.npz")
    ap.add_argument("--ref", default=None)
    ap.add_argument("--unet")
    ap.add_argument("--ipa")
    ap.add_argument("--vae")
    ap.add_argument("--controlnet")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "record":
        record(args)
        return
    sys.exit(1 if compare(args) else 0)


if __name__ == "__main__":
    main()
