"""Builds the SDXL guidance stack of a configuration for either side, as
benchmark/stack.py builds the SD1.5 one: the port's generalised
diffusion/unet.py and guidance/ipa.py, or the plain reference's SDXL
modules (reference/gip_ref/diffusion/unet_xl.py, guidance/ipa_xl.py)
under the same names, so that stack.py's functions build both sides."""

from __future__ import annotations

import importlib

import torch

from . import inputs, stack


def package(root: str):
    """stack.package(root), with the reference's SDXL UNet, ControlNet and
    guidance in place of its SD1.5 ones."""
    pkg = stack.package(root)
    if root == stack.REFERENCE:
        pkg.unet = importlib.import_module(f"{root}.diffusion.unet_xl")
        pkg.ipa = pkg.prompts = importlib.import_module(
            f"{root}.guidance.ipa_xl")
    return pkg


def pooled_embeddings(seed: int, dim: int, directions: int,
                      device) -> tuple:
    """The pooled text embeddings, N(0, 1), in PromptEmbeddings' order:
    view-dependent positive and negative [directions, dim], null and plain
    [dim]."""
    gen = inputs.generator(seed, "pooled", device)
    d = lambda *s: torch.randn(s, generator=gen, device=device)
    return (d(directions, dim), d(directions, dim), d(dim), d(dim))


def guidance(pkg, cfg: dict, models, seed: int, device):
    """stack.guidance's AHDSGuidance, its prompts carrying the seed's
    pooled embeddings."""
    guid = stack.guidance(pkg, cfg, models, seed, device)
    c = cfg["conditioning"]
    pooled = pkg.prompts.PromptEmbeddings(*pooled_embeddings(
        seed, c["pooled_dim"], c["directions"], device))
    guid.prompt_embeds = guid.prompt_embeds._replace(pooled=pooled)
    return guid
