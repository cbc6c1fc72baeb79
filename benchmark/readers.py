"""What the per-layer metrics read from a traced run. A reader takes the
run's context (`trace`: the profiled units' device and host ops, their
window and the kernels' launch counts; `work`: the entry's operations per
unit; `unit_s`: the untraced window's seconds per unit) and returns a
number, or None where it finds nothing to read."""

from __future__ import annotations

from . import peaks
from . import trace as tr

K3_KERNELS = ("conv3x3_wgmma_kernel", "splitk_sum_kernel", "conv3x3_kernel")
COMPOSITE_KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel")


def _kernels(ctx) -> list:
    return [r for r in ctx.trace["device"]
            if not r[0].startswith(("Memcpy", "Memset"))]


def device_idle(ctx):
    """The share of the units' time in which no device op ran, %: the
    traced units' device time over their time in the untraced window (the
    profiler's own host work stretches the traced window, not the device
    ops)."""
    span = ctx.trace["units"] * ctx.unit_s
    if not ctx.trace["device"] or span <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(ctx.trace["device"]) / span)


def mfu(ctx):
    """The least time of a unit's operations at the chip's peak of their
    precision, over the measured time of a unit, %."""
    least = sum(f / peaks.FLOPS[p] for p, f in ctx.work["flops"].items())
    return 100.0 * least / ctx.unit_s if least > 0 else None


def k3_roofline(ctx):
    """K3's least time (operations at the bf16 peak, or bytes at the
    memory's, whichever is longer) over its kernels' device time, %.
    Nothing when the K3 launch counter disagrees with the launches that
    the count assumes."""
    k3 = ctx.work.get("k3")
    n = ctx.trace["units"]
    if not k3 or ctx.trace["launches"].get("K3") != k3["launches"] * n:
        return None
    t = tr.device_time_s(ctx.trace["device"],
                         lambda s: s.startswith(K3_KERNELS)
                         or any(k in s for k in K3_KERNELS))
    if t <= 0:
        return None
    least = max(k3["flops"] / peaks.FLOPS["bf16"],
                k3["bytes"] / peaks.BYTES_PER_S) * n
    return 100.0 * least / t


def launches_per_unit(ctx):
    """Device kernels in the trace per unit (copies and sets left out)."""
    k = _kernels(ctx)
    return len(k) / ctx.trace["units"] if k else None


def composite_ms(ctx):
    """The compositor's device ms per unit (K1 + K2)."""
    t = tr.device_time_s(ctx.trace["device"],
                         lambda s: any(k in s for k in COMPOSITE_KERNELS))
    return t * 1e3 / ctx.trace["units"] if t > 0 else None
