"""What each cell brings for the CPU tests, found by name, as the run
path finds its own files. A cell adds, besides its `BENCHMARK.json` entry
(and its name in the `workloads` lists of the metrics it reports), only
new files:

  benchmark/workloads/<cell>.json        the traffic, its entry, limits
  benchmark/tests/cells/<cell>.json      {"params": tiny params,
                                          "limits": tiny limits}; a limit
                                          not named keeps the cell's own
  a new configuration's                  benchmark/configs/<config>.json and
                                          benchmark/tests/configs/<config>.json
                                          (its tiny widths: each key's group
                                          updated, any other key replaced)
  a new entry's                          benchmark/entries/<entry>.py and
                                          benchmark/tests/timed_faults/
                                          <entry>.py (`KINDS`, and
                                          `break_timed(monkeypatch, kind)`
                                          that breaks the program's timed
                                          path so)
  new metrics and reference modules      their own files

A cell without these files fails `test_every_cell_brings_its_test_files`,
which names each missing file, and nothing fails at collection.

The tiny limits were set as the cells' own (benchmark/control.py, here
on the CPU: the program on 8 seeds, 6 for the refine, the control and the
planted fault on 3):

  stage 1  grad: program up to 6.3e-3, float8 control from 1.43e-2 (under
           three times), half the batch from 0.25 -> 5e-2; change:
           program up to 6.7e-3, control 8.0e-3 to 1.7e-2, half the batch
           from 2.5e-2, the state unchanged 1 -> 3e-2; grad_diff: program
           0.032 to 0.040, control from 0.34, half the batch 0.97 -> 0.12
           (loss: program up to 6.8e-4, control from 8.1e-4; not compared,
           as on the card).
  stage 2  rms: program up to 1.10e-2, control from 9.8e-2 -> 3e-2.
  stage 3  the cell's own limits: both sides are the same float32 code on
           the CPU and read 0; TF32 does not exist there."""

import importlib
import os

from benchmark.run import load_json as _load

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)


def _workload(cell: str):
    """The cell's workload file, or None where it is missing."""
    path = os.path.join(BENCH, "workloads", f"{cell}.json")
    return _load(path) if os.path.exists(path) else None


def needed_files(cell: str) -> list:
    """The files the cell needs for the CPU tests (the workload file, and
    then its three test files under TESTS)."""
    wl = _workload(cell)
    if wl is None:
        return [os.path.join(BENCH, "workloads", f"{cell}.json"),
                os.path.join(TESTS, "cells", f"{cell}.json")]
    return [os.path.join(TESTS, "cells", f"{cell}.json"),
            os.path.join(TESTS, "configs", f"{wl['config']}.json"),
            os.path.join(TESTS, "timed_faults", f"{wl['entry']}.py")]


def missing_files(cells) -> list:
    """Each file of `needed_files` that is not there, over the cells."""
    return [p for c in cells for p in needed_files(c)
            if not os.path.exists(p)]


def timed_faults(cell: str):
    """The cell's entry's timed-fault module, or None where the workload or
    the module is missing."""
    wl = _workload(cell)
    if wl is None:
        return None
    name = f"benchmark.tests.timed_faults.{wl['entry']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def fault_kinds(cell: str) -> tuple:
    mod = timed_faults(cell)
    return tuple(mod.KINDS) if mod is not None else ()


def shrink_config(cfg: dict) -> None:
    """The configuration at its tiny widths: tests/configs/<name>.json."""
    for k, v in _load(os.path.join(TESTS, "configs",
                                   f"{cfg['name']}.json")).items():
        if isinstance(cfg.get(k), dict):
            cfg[k].update(v)
        else:
            cfg[k] = v


def shrink(cfg: dict, wl: dict) -> None:
    """The configuration and the cell `wl` at their tiny sizes."""
    shrink_config(cfg)
    cell = _load(os.path.join(TESTS, "cells", f"{wl['name']}.json"))
    wl["params"].update(cell["params"])
    if "limits" in wl:
        wl["limits"].update(cell["limits"])
