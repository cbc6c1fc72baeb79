"""Reading a torch.profiler trace: the device's operations (kernels,
copies, sets) and the host's ranges, as (name, start ns, duration ns),
and what the metrics and the breakdown take from them."""

from __future__ import annotations

import time
from collections import defaultdict


def _events(prof):
    """(device ops, host ops) of a finished profile."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        row = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        if kind.endswith("CUDA"):
            dev.append(row)
        elif kind.endswith("CPU"):
            host.append(row)
    return dev, host


def profile(unit, n: int, sync, cuda: bool = True) -> dict:
    """Runs `unit` n times under the profiler. -> {"device": [...], "host":
    [...], "window_s": the host's wall from the first unit to the last
    synchronise, "units": n}."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            unit()
        sync()
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    return {"device": dev, "host": host, "window_s": window, "units": n}


def busy_intervals(device) -> list:
    """The union of the device ops' intervals, as sorted [start, end] ns."""
    out = []
    for _, s, d in sorted(device, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def busy_s(device) -> float:
    return sum(e - s for s, e in busy_intervals(device)) * 1e-9


def device_time_s(device, match) -> float:
    """Seconds of the device ops whose name `match` accepts."""
    return sum(d for name, _, d in device if match(name)) * 1e-9


def top_ops(device, k: int = 10) -> list:
    tot = defaultdict(int)
    for name, _, d in device:
        tot[name] += d
    return [[n[:120], t * 1e-9] for n, t in
            sorted(tot.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(device, host, k: int = 10) -> list:
    """The k longest gaps between device ops, each named by the innermost
    host range that holds its start (what the host was doing)."""
    iv = busy_intervals(device)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(iv, iv[1:])),
                  reverse=True)[:k]
    out = []
    for length, start in gaps:
        inside = [(d, n) for n, s, d in host if s <= start < s + d]
        name = min(inside)[1] if inside else "unknown"
        out.append([name[:120], length * 1e-9])
    return out
