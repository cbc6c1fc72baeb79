"""mfu.sdxl: the SDXL stage-1 unit's least time at the H100's peaks (its
operations counted from the published widths by benchmark/flops_xl.py)
over its measured time, %."""

from benchmark.readers import mfu as read  # noqa: F401
