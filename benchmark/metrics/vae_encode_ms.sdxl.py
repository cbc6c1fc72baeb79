"""vae_encode_ms.sdxl: the guidance's VAE encode of the 4 views at
1024^2, its device ms per SDXL stage-1 step, forward and backward (the
program's spans `vae_encode` and `vae_encode.backward`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vae_encode", "vae_encode.backward")
