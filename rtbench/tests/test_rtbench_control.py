"""The check's controls at a size the CPU can run: the precision control
(the reference in bfloat16 in the program's place) and every fault a cell
can have, planted in the program underneath a whole run, each come out as
not correct under the cell's limits; the sound program comes out correct."""
from __future__ import annotations

import pytest
import torch

from rtbench import control, harness
from rtbench.tests.conftest import SEED, cells


def _run(root, cell, seconds=0.3):
    return harness.Run(root, cell, SEED, seconds, False, torch.device("cpu"))


def _fails(readings: dict, limits: dict) -> bool:
    return any(not (v <= limits[k]) for k, v in readings.items())


@pytest.mark.parametrize("cell", cells())
def test_precision_control_fails_and_program_passes(tiny_root, cell):
    run = _run(tiny_root, cell)
    out = control.readings(run, 0.3)
    assert not _fails(out["program"], run.limits), out["program"]
    assert _fails(out["control"], run.limits), out["control"]
    for fault in control.FAULTS[run.mix["loop"]]:
        assert _fails(out[fault], run.limits), (fault, out[fault])


FAULT_CASES = [(c, f) for c in cells()
               for f in control.FAULTS["live" if c.endswith(".view")
                                       else "sgd"]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_run_with_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    run = _run(tiny_root, cell)
    with control.FAULTS[run.mix["loop"]][fault]():
        res = harness.run_cell(run, 0.0)
    assert res["correct"] is False, res["checks"]
