"""vae_encode_ms.stage1: the guidance's VAE encode, its device ms per
stage-1 step, forward and backward (the program's spans `vae_encode` and
`vae_encode.backward`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vae_encode", "vae_encode.backward")
