"""refine_vae_s.stage2: the VAE encode's and decode's device seconds in a
refine (CUDA events at refine_views' on_phase hooks)."""


def read(ctx):
    vae_s = getattr(ctx.entry, "vae_s", None)
    return vae_s() if vae_s is not None else None
