"""device_idle.flux: the share of the FLUX stage-1 units' time in the
untraced window in which no operation ran on the device (device time from
torch.profiler over the traced units), %."""

from benchmark.readers import device_idle as read  # noqa: F401
