"""transformer_mfu.sdxl: the transformer layers' share of their roofline
in the SDXL denoise: their operations (benchmark/flops_xl.py, counted on
the reference's Transformer2D layers of a ControlNet + UNet call) at the
H100's bf16 peak, over the device time of the program's `transformer`
spans (16 a call: 11 in the UNet, 5 in the ControlNet), %."""

from benchmark import peaks
from benchmark.spans import device_ms


def read(ctx):
    ops = ctx.work.get("transformer_flops")
    ms = device_ms(ctx, "transformer")
    if not ops or not ms:
        return None
    return 100.0 * ops / peaks.FLOPS["bf16"] / (ms * 1e-3)
