"""render_ms.stage1: the render's device ms per stage-1 step, forward and
backward (the program's spans `render` and `render.backward`)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "render", "render.backward")
