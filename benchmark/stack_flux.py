"""Builds the FLUX.1-dev guidance stack of a configuration for either side:
the port's diffusion/flux.py (its parameters held at the side's dtype),
its 16-channel VAE and guidance/ipa.py's velocity path, or the plain
reference's diffusion/flux.py, diffusion/vae_flux.py and
guidance/ipa_flux.py under the same names.

The weights are drawn one parameter at a time: benchmark/inputs'
random_weights draws one flat float32 tensor, which would be the whole
model's 62.7 GB here. Each parameter of two or more dimensions gets its
own normal draw from inputs.sub_seed(seed, "<what>.<name>") on the
device, scaled by inputs.init_std (the ControlNet's zero-initialised
Linears by zero_conv_scale more) and cast to the parameter's dtype at
once, so that neither side holds a whole-model float32 draw and both get
the same numbers (the program's rounded to its dtype); norm scales (a 1-D
`weight`) are one, other 1-D parameters zero."""

from __future__ import annotations

import importlib

import torch

from . import inputs, stack, stack_xl

# the ControlNet's zero-initialised Linears
ZERO_LINEARS = ("controlnet_blocks.", "controlnet_single_blocks.",
                "controlnet_x_embedder.")


def package(root: str):
    """stack.package(root) with `flux`; the reference's FLUX VAE and
    guidance in place of its SD ones."""
    pkg = stack.package(root)
    pkg.flux = importlib.import_module(f"{root}.diffusion.flux")
    if root == stack.REFERENCE:
        pkg.vae = importlib.import_module(f"{root}.diffusion.vae_flux")
        pkg.ipa = pkg.prompts = importlib.import_module(
            f"{root}.guidance.ipa_flux")
    return pkg


def random_weights(module, seed: int, what: str, device,
                   zero_scale: float = 0.0) -> dict:
    """A state dict for `module` (any device; names, shapes and dtypes are
    read), drawn a parameter at a time (the module's docstring)."""
    out = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if len(shape) >= 2:
            std = inputs.init_std(name, shape, zero_scale)
            if name.startswith(ZERO_LINEARS):
                std *= zero_scale
            gen = inputs.generator(seed, f"{what}.{name}", device)
            out[name] = torch.randn(shape, generator=gen,
                                    device=device).mul_(std).to(p.dtype)
        elif name.rsplit(".", 1)[-1] == "weight":
            out[name] = torch.ones(shape, dtype=p.dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=p.dtype, device=device)
    return out


def flux_configs(pkg, cfg: dict, dtype) -> tuple:
    """(FluxConfig of the transformer, of the ControlNet)."""
    t = dict(cfg["transformer"], axes_dims_rope=tuple(
        cfg["transformer"]["axes_dims_rope"]))
    c = cfg["controlnet"]
    return (pkg.flux.FluxConfig(dtype=dtype, **t),
            pkg.flux.FluxConfig(dtype=dtype, **{
                **t, "num_layers": c["num_layers"],
                "num_single_layers": c["num_single_layers"],
                "ip_tokens": 0}))


def vae_config(pkg, cfg: dict, dtype):
    v = dict(cfg["vae"], block_out_channels=tuple(
        cfg["vae"]["block_out_channels"]))
    return pkg.vae.VAEConfig(dtype=dtype, **v)


def models_on_meta(pkg, cfg: dict, dtype) -> tuple:
    """(transformer, ControlNet, VAE) on the meta device."""
    tcfg, ccfg = flux_configs(pkg, cfg, dtype)
    c = cfg["controlnet"]
    vcfg = vae_config(pkg, cfg, dtype)
    return (inputs.on_meta(lambda: pkg.flux.FluxTransformer(tcfg)),
            inputs.on_meta(lambda: pkg.flux.FluxControlNet(
                ccfg, c["num_mode"], c["mode"])),
            inputs.on_meta(lambda: pkg.vae.AutoencoderKL(vcfg)))


def diffusion_models(pkg, cfg: dict, seed: int, device, dtype):
    """(transformer, ControlNet, VAE) with the seed's weights."""
    zero = cfg["init"]["zero_conv_scale"]
    return tuple(
        inputs.load(m, random_weights(m, seed, what, device, s))
        for m, what, s in zip(models_on_meta(pkg, cfg, dtype),
                              ("transformer", "controlnet", "vae"),
                              (0.0, zero, 0.0)))


def guidance(pkg, cfg: dict, models, seed: int, device):
    """The stage-1 guidance on the velocity prior `models`, with the seed's
    conditioning: N(0, 1) T5 tokens, pooled vectors and identity tokens
    (at the T5 width, the IP projections' input)."""
    c = cfg["conditioning"]
    e = inputs.embeddings(seed, c["text_tokens"], c["context_dim"],
                          cfg["transformer"]["ip_tokens"], c["directions"],
                          device)
    pooled = pkg.prompts.PromptEmbeddings(*stack_xl.pooled_embeddings(
        seed, c["pooled_dim"], c["directions"], device))
    pe = pkg.prompts.PromptEmbeddings(e["text_vd"], e["uncond_vd"],
                                      e["null"], e["text"], pooled)
    img = pkg.ipa.ImageEmbeds(e["ip_pos"], e["ip_null"], e["ip_neg"])
    return pkg.ipa.AHDSGuidance(pkg.ipa.GuidanceModels(*models), pe, img,
                                pkg.ipa.GuidanceConfig(**cfg["guidance"]))
