"""denoise_idle_ms.stage1: the device's idle ms per stage-1 step in gaps
that open while the host is inside the program's span `denoise`, scaled
to the untraced window's idle time."""

from benchmark.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "denoise")
