"""flux_ms.flux: the FLUX.1-dev transformer's call (19 double-stream and 38
single-stream blocks, the IP attention) in the guidance's denoise, its
device ms per stage-1 step (the program's span `flux`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "flux")
