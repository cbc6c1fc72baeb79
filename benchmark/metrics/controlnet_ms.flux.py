"""controlnet_ms.flux: the Union ControlNet's call (5 double-stream and 10
single-stream blocks) in the guidance's denoise, its device ms per FLUX
stage-1 step (the program's span `controlnet`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "controlnet")
