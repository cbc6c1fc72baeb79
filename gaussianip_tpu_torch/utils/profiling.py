"""Tracing and profiling hooks (port of gaussianip_tpu/utils/profiling.py):
  * Counters: named scalar sums and counts, dumped as JSON;
  * StageTimer: wall-clock per named stage, written into the run manifest
    as wall_s_<name>;
  * trace(logdir): a torch.profiler trace of a region (CPU, plus CUDA when
    a card is present), written to <logdir>/trace.json for Perfetto or
    chrome://tracing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class Counters:
    def __init__(self):
        self.values: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, value: float):
        self.values[name] += float(value)
        self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.values[name] / max(self.counts[name], 1)

    def dump(self, path: Optional[str] = None) -> dict:
        out = {k: {"sum": v, "n": self.counts[k], "mean": self.mean(k)}
               for k, v in self.values.items()}
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                json.dump(out, f, indent=2)
        return out


class StageTimer:
    """Wall-clock per named stage; integrates with RunDirs.manifest."""

    def __init__(self, manifest_fn=None):
        self.times: Dict[str, float] = {}
        self._manifest_fn = manifest_fn

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self._manifest_fn is not None:
                self._manifest_fn(**{f"wall_s_{name}": round(self.times[name], 2)})


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed region -> <logdir>/trace.json.
    Yields the profiler (key_averages() for sums by operator)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
