"""k3_roofline.stage2: K3's share of its roofline in the stage2 unit: the least
time of the stride-1 3x3 convs of each ControlNet + UNet call over the
device time of K3's kernels, %; nothing when the K3 launch counter
disagrees with the count."""

from benchmark.readers import k3_roofline as read  # noqa: F401
