"""unet_ms.sdxl: the SDXL UNet's call in the guidance's denoise, its
device ms per stage-1 step (the program's span `unet`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "unet")
