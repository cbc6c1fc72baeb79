"""composite_ms.stage3: the compositor's device ms per stage-3 step (K1's
and K2's kernels in the trace)."""

from benchmark.readers import composite_ms as read  # noqa: F401
