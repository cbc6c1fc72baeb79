"""Operation and byte counts from the published widths and a cell's
shapes, independent of what the port launches: the plain reference's
modules are run on the meta device (shapes only, no memory, no arithmetic)
under torch.utils.flop_counter.FlopCounterMode, which counts 2 * m * n * k
per matmul and per convolution's im2col product, forward and backward.

The 3x3 convs that K3 carries are counted apart: every stride-1 Conv3x3 of
the ControlNet and the UNet, at 2 * B * H * W * Ci * Co * 9 operations, and
its input, weight (bf16) and output bytes, each read or written once.

K1 / K2's bound arithmetic (operations per (instance, pixel) pair and the
bytes per instance, after csrc/composite.cu) is kept here too, for a later
roofline of the compositor: it needs a pair count that the benchmark
computes itself, which it does not yet."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import stack

# K1 / K2: f32 operations per (instance, pixel) pair up to the pixel's last
# contributor, K2's fused epilogue per instance, the bytes each reads and
# writes once
K12_OPS_PER_PAIR = {"k1": 23, "k2": 44}
K2_EPILOGUE_OPS = 37
K12_BYTES_PER_INSTANCE = 64
K2_EPILOGUE_BYTES = 8 + 24 + 40


def k12_bound(pairs: int, touched: int, live: int, out_bytes: int) -> dict:
    """(operations, bytes) of K1 and K2 for a render's pair counts."""
    return {
        "k1": (pairs * K12_OPS_PER_PAIR["k1"],
               live * K12_BYTES_PER_INSTANCE + out_bytes),
        "k2": (pairs * K12_OPS_PER_PAIR["k2"] + touched * K2_EPILOGUE_OPS,
               touched * (K12_BYTES_PER_INSTANCE + K2_EPILOGUE_BYTES)
               + 2 * out_bytes)}


def _meta_models(cfg: dict):
    pkg = stack.package(stack.REFERENCE)
    ucfg, ccfg = stack.unet_configs(pkg, cfg, torch.float32)
    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    emb = tuple(cfg["controlnet"]["conditioning_embed_channels"])
    with torch.device("meta"):
        return (pkg, pkg.unet.UNet2DConditionModel(ucfg),
                pkg.unet.ControlNetModel(ccfg,
                                         conditioning_embed_channels=emb),
                pkg.vae.AutoencoderKL(pkg.vae.VAEConfig(**v)))


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def denoise_call(cfg: dict, batch: int, latent: int) -> dict:
    """One ControlNet + UNet call at `batch` rows of latent^2 latents:
    {"flops": total, "k3_flops", "k3_bytes", "k3_sites"}."""
    pkg, unet, cn, _ = _meta_models(cfg)
    c = cfg["conditioning"]
    m = dict(device="meta")
    lat = torch.empty(batch, cfg["unet"]["in_channels"], latent, latent, **m)
    t = torch.zeros(batch, dtype=torch.int64, **m)
    ctx = torch.empty(batch, c["text_tokens"] + cfg["unet"]["ip_tokens"],
                      c["context_dim"], **m)
    side = latent * (2 ** (len(cfg["vae"]["block_out_channels"]) - 1))
    control = torch.empty(batch, 3, side, side, **m)
    k3 = {"flops": 0, "bytes": 0, "sites": 0}

    def hook(mod, args, out):
        if mod.stride != 1:
            return
        b, ci, h, w = args[0].shape
        co = mod.weight.shape[0]
        k3["flops"] += 2 * b * h * w * ci * co * 9
        k3["bytes"] += 2 * (b * h * w * (ci + co) + 9 * ci * co)
        k3["sites"] += 1

    hooks = [mod.register_forward_hook(hook)
             for net in (unet, cn) for mod in net.modules()
             if type(mod).__name__ == "Conv3x3"]

    def call():
        with torch.no_grad():
            res, mid = cn(lat, t, ctx, control)
            unet(lat, t, ctx, down_block_residuals=res,
                 mid_block_residual=mid, ip_scale=1.0)

    total = _counted(call)
    for h in hooks:
        h.remove()
    return {"flops": total, "k3_flops": k3["flops"],
            "k3_bytes": k3["bytes"], "k3_sites": k3["sites"]}


def vae_encode(cfg: dict, batch: int, side: int,
               backward: bool = False) -> int:
    """The VAE encode of `batch` side^2 images; with `backward`, also the
    gradient to the images (the weights are frozen)."""
    _, _, _, vae = _meta_models(cfg)
    vae.requires_grad_(False)
    x = torch.empty(batch, 3, side, side, device="meta",
                    requires_grad=backward)
    lat = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    eps = torch.empty(batch, cfg["vae"]["latent_channels"], side // lat,
                      side // lat, device="meta")

    def call():
        z = vae.encode(x, eps)
        if backward:
            z.sum().backward()

    return _counted(call)


def lpips(cfg: dict, batch: int, height: int, width: int,
          backward: bool = False) -> int:
    """LPIPS (VGG16) on `batch` images of height x width (both of each
    compared pair run through the VGG as one batch); with `backward`, also
    the gradient to the images (the weights are frozen)."""
    pkg = stack.package(stack.REFERENCE)
    stages = tuple(tuple(s) for s in cfg["lpips"]["stages"])
    with torch.device("meta"):
        m = pkg.lpips.LPIPS(stages).requires_grad_(False)
    x = torch.empty(batch // 2, height, width, 3, device="meta",
                    requires_grad=backward)
    y = torch.empty(batch // 2, height, width, 3, device="meta")

    def call():
        d = m(x, y)
        if backward:
            d.sum().backward()

    return _counted(call)


def refine(cfg: dict, p: dict) -> dict:
    """One refine: the VAE encode and decode of the views at their side,
    and per denoise step the anchors' (`store`), the keys' (`key`, their
    up blocks attending over twice the tokens) and each dense group's
    (`dense`, over self, left and right) ControlNet + UNet call on the
    CFG-doubled batch. Keys as denoise_call."""
    pkg, unet, cn, vae = _meta_models(cfg)
    c = cfg["conditioning"]
    m = dict(device="meta")
    side = p["resolution"]
    lat = side // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    k3 = {"flops": 0, "bytes": 0, "sites": 0}

    def hook(mod, args, out):
        if mod.stride == 1:
            b, ci, h, w = args[0].shape
            co = mod.weight.shape[0]
            k3["flops"] += 2 * b * h * w * ci * co * 9
            k3["bytes"] += 2 * (b * h * w * (ci + co) + 9 * ci * co)
            k3["sites"] += 1

    hooks = [mod.register_forward_hook(hook)
             for net in (unet, cn) for mod in net.modules()
             if type(mod).__name__ == "Conv3x3"]

    def call(views, mode, cache=None, weights=None):
        rows = 2 * views
        x = torch.empty(rows, cfg["unet"]["in_channels"], lat, lat, **m)
        t = torch.zeros(rows, dtype=torch.int64, **m)
        ctx = torch.empty(rows, c["text_tokens"] + cfg["unet"]["ip_tokens"],
                          c["context_dim"], **m)
        res, mid = cn(x, t, ctx, torch.empty(rows, 3, side, side, **m))
        return unet(x, t, ctx, down_block_residuals=res,
                    mid_block_residual=mid, vcr_mode=mode, vcr_cache=cache,
                    vcr_weights=weights)

    groups = pkg.refine.dense_groups(p["dense_batch"])
    counts = {}

    def steps():
        with torch.no_grad():
            _, ca = call(4, "store")
            _, ck = call(4, "key", ca)
            comb = [torch.cat([a, k]) for a, k in zip(ca, ck)]
            w = dict(w_l=0.5, w_r=0.5, lambda_self=p["lambda_self"])
            for _, names in groups:
                src = [x[:2 * len(names)] for x in comb]
                call(len(names), "dense", (src, src), w)

    def codec():
        with torch.no_grad():
            x = torch.empty(p["views"], 3, side, side, **m)
            vae.decode(vae.encode(x))

    counts["steps"] = _counted(steps) * p["num_steps"]
    sites = k3["sites"]
    per_step = {k: v * p["num_steps"] for k, v in k3.items()}
    counts["codec"] = _counted(codec)
    for h in hooks:
        h.remove()
    return {"flops": counts["steps"] + counts["codec"],
            "k3_flops": per_step["flops"], "k3_bytes": per_step["bytes"],
            "k3_sites": sites * p["num_steps"]}
