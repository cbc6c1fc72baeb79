"""launches_per_step.stage3: device kernels in the trace per stage3 step."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
