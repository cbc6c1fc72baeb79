"""denoise_ms.stage1: the guidance's denoise (ControlNet + UNet on the CFG
batch, the noising and ANPG), its device ms per stage-1 step (the
program's span `denoise`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "denoise")
