"""pose_encode_ms.flux: the VAE encode of the 4 pose maps at 1024^2 (the
Union ControlNet's hint), its device ms per FLUX stage-1 step (the
program's span `pose_encode`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "pose_encode")
