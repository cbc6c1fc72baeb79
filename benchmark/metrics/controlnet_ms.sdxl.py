"""controlnet_ms.sdxl: the SDXL OpenPose ControlNet's call in the
guidance's denoise, its device ms per stage-1 step (the program's span
`controlnet`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "controlnet")
