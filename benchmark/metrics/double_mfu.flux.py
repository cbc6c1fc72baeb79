"""double_mfu.flux: the double-stream blocks' share of the bf16 peak in
the FLUX denoise: their operations (benchmark/flops_flux.py, counted on
the reference's blocks of a ControlNet + transformer call: 5 + 19) at
the H100's bf16 peak, over the device time of the program's
`double_block` spans, %."""

from benchmark import peaks
from benchmark.spans import device_ms


def read(ctx):
    ops = ctx.work.get("double_flops")
    ms = device_ms(ctx, "double_block")
    if not ops or not ms:
        return None
    return 100.0 * ops / peaks.FLOPS["bf16"] / (ms * 1e-3)
