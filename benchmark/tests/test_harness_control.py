"""The comparisons against their control and planted faults, at a size
the CPU holds: a sound run of each cell is correct, the program's int8
tower (the step below the configuration's bfloat16) is not, and neither is
a run with its timed path broken under it. The readings at the cells' own
size are ``python -m benchmark.control`` on the card (PERF.md)."""

from __future__ import annotations

import pytest

from benchmark.faults import KINDS
from benchmark.tests.small import SMALL, limits, reading

CELLS = sorted(SMALL)

# what each fault must break; the others may stay within their limits
BREAKS = {"half_batch": "tower_sq_err", "row": "tower_sq_err",
          "shuffle": "ward_excess", "oversize": "partition_faults",
          "unnamed": "unnamed_clusters", "report": "report_faults"}

# each cell meets the faults whose number it compares
FAULTS = [(cell, fault) for cell in CELLS for fault in sorted(KINDS)
          if BREAKS[fault] in limits(cell)]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_correct(cell):
    r = reading(cell, "sound")
    assert r["correct"], r


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct(cell):
    r = reading(cell, "control")
    assert not r["correct"], r
    assert r["checks"]["tower_sq_err"] > limits(cell)["tower_sq_err"]


@pytest.mark.parametrize(("cell", "fault"), FAULTS)
def test_fault_not_correct(cell, fault):
    r = reading(cell, "fault", fault=fault)
    assert not r["correct"], r
    assert r["checks"][BREAKS[fault]] > limits(cell)[BREAKS[fault]]
