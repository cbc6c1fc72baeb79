"""k3_roofline.sdxl: K3's share of its roofline in the SDXL stage-1 unit:
the least time of the 52 stride-1 3x3 convs of each ControlNet + UNet call
(16 + 36) over the device time of K3's kernels, %; nothing when the K3
launch counter disagrees with the count."""

from benchmark.readers import k3_roofline as read  # noqa: F401
