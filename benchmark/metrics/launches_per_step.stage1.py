"""launches_per_step.stage1: device kernels in the trace per stage1 step."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
