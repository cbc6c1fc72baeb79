"""What the per-layer metrics of the program's spans read
(gaussianip_tpu_torch/utils/profiling.py): the span records of the traced
units, per unit, and the device's idle time by the span that the host was
in when each gap opened. Every reader returns None where the program
records no such span, as a program without spans does."""

from __future__ import annotations

from . import trace as tr


def records(ctx) -> list:
    """The span records of the last ctx.trace["units"] steps. The program
    empties its table when read, so the first reader reads it and keeps
    the records on the context for the others."""
    got = getattr(ctx, "spans", None)
    if got is None:
        from gaussianip_tpu_torch.utils import profiling

        read = getattr(profiling, "spans", None)
        got = read() if read is not None else []
        steps = sorted({r["step"] for r in got if r["step"] is not None})
        keep = set(steps[-ctx.trace["units"]:])
        got = ctx.spans = [r for r in got if r["step"] in keep]
    return got


def _named(ctx, names) -> list:
    return [r for r in records(ctx) if r["name"] in names]


def device_ms(ctx, *names):
    """The device ms a unit between the entry and exit events of the spans
    `names`; None without such spans or off a card."""
    rs = _named(ctx, names)
    if not rs or any(r["device_ms"] is None for r in rs):
        return None
    return sum(r["device_ms"] for r in rs) / ctx.trace["units"]


def host_ms(ctx, *names):
    """The host ms a unit inside the spans `names` (their time.time_ns()
    intervals in the traced run)."""
    rs = _named(ctx, names)
    if not rs:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in rs) * 1e-6 \
        / ctx.trace["units"]


def idle_ms(ctx, *names):
    """The device's idle ms a unit owned by the spans `names`: of the gaps
    between the traced units' device ops, those that open while the host
    is inside one of the spans (both on the clock of time.time_ns()), as a
    share of all the gaps' time, times the untraced idle a unit (the
    untraced unit time less the busy time a unit). The profiler stretches
    the traced host, not the device ops, as in device_idle."""
    rs = _named(ctx, names)
    iv = tr.busy_intervals(ctx.trace["device"])
    gaps = [(a[1], b[0] - a[1]) for a, b in zip(iv, iv[1:])]
    total = sum(g for _, g in gaps)
    if not rs or total <= 0:
        return None
    own = sum(g for s, g in gaps
              if any(r["start_ns"] <= s < r["end_ns"] for r in rs))
    n = ctx.trace["units"]
    idle_s = ctx.unit_s - tr.busy_s(ctx.trace["device"]) / n
    return own / total * idle_s * 1e3
