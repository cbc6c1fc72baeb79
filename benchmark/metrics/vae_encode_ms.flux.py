"""vae_encode_ms.flux: the guidance's VAE encode of the 4 views at 1024^2
through FLUX's 16-channel VAE, its device ms per stage-1 step, forward and
backward (the program's spans `vae_encode` and `vae_encode.backward`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vae_encode", "vae_encode.backward")
