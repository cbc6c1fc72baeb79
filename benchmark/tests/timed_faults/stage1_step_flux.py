"""Faults planted in the timed path of entry `stage1_step_flux`, which
builds its step with entry stage1_step's `_make_step`: the program's
step broken as benchmark/tests/timed_faults/stage1_step.py breaks it (the
state handed back unchanged, or half of the views left out). The
reference's steps stay sound."""

from benchmark.tests.timed_faults.stage1_step import (  # noqa: F401
    KINDS,
    break_timed,
)
