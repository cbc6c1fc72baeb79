"""denoise_enqueue_ms.stage1: the host ms per stage-1 step inside the
program's span `denoise` (its time.time_ns() interval in the traced run):
the time to enqueue the denoise, under the profiler's own cost."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "denoise")
