"""lpips_ms.stage3: the stage-3 loss (crop, halving, L1 and LPIPS), its
device ms per step, forward and backward (the program's spans `loss` and
`loss.backward`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "loss", "loss.backward")
