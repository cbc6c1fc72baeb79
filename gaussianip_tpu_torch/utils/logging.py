"""Scalar metrics logging: CSV always, TensorBoard when tensorboardX
imports (port of gaussianip_tpu/utils/logging.py)."""

from __future__ import annotations

import csv
import os
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 use_csv: bool = True):
        self.tb = None
        self.csv_path = None
        self._csv_fields = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(os.path.join(log_dir, "tb"))
        if use_csv:
            os.makedirs(log_dir, exist_ok=True)
            self.csv_path = os.path.join(log_dir, "metrics.csv")

    def log(self, step: int, metrics: Dict[str, float]):
        scalars = {k: float(v) for k, v in metrics.items()
                   if hasattr(v, "__float__") or isinstance(v, (int, float))}
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
        if self.csv_path is not None:
            fields = ["step"] + sorted(scalars)
            write_header = (self._csv_fields != fields
                            or not os.path.exists(self.csv_path))
            mode = "a" if os.path.exists(self.csv_path) and not write_header \
                else ("a" if self._csv_fields == fields else "w")
            with open(self.csv_path, mode, newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                if write_header:
                    w.writeheader()
                    self._csv_fields = fields
                w.writerow({"step": step, **scalars})

    def close(self):
        if self.tb is not None:
            self.tb.close()
