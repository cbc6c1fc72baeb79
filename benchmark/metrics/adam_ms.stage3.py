"""adam_ms.stage3: the step's tail after the backward (the densify
statistics, Adam, the metrics), its device ms per stage-3 step (the
program's span `adam`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "adam")
