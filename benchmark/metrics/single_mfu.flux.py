"""single_mfu.flux: the single-stream blocks' share of the bf16 peak in
the FLUX denoise: their operations (benchmark/flops_flux.py, counted on
the reference's blocks of a ControlNet + transformer call: 10 + 38) at
the H100's bf16 peak, over the device time of the program's
`single_block` spans, %."""

from benchmark import peaks
from benchmark.spans import device_ms


def read(ctx):
    ops = ctx.work.get("single_flops")
    ms = device_ms(ctx, "single_block")
    if not ops or not ms:
        return None
    return 100.0 * ops / peaks.FLOPS["bf16"] / (ms * 1e-3)
