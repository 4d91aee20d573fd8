"""On the card, at a test size: the program's compared numbers come out
correct against the cell's limits, and the control (the plain reference
in the program's place, computed in TF32) and each planted fault (the
train cells' loss over half the batch) come out not correct, judged as a
run judges its own (``control.judged``). Skips without a card."""

import time

import pytest

from portbench import control, harness
from portbench.tests.cpu_run import tiny_files

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", ["train.resnet34_8s", "train.resnet101_8s",
                                  "serve.resnet34_8s.c16", "serve.resnet34_8s.c1"])
def test_program_correct_and_control_and_faults_not(cuda, cell):
    files = tiny_files(cell, 3 if cell.endswith("c16") else None)
    ctx = harness.Context(cell, files, 2**31 + 99, 2.0, False, cuda, time.perf_counter())
    kind = files["workload"]["driver"]
    readings = (control.train_readings if kind == "train" else control.serve_readings)(ctx, True)
    verdict = control.judged(readings, ctx.limits)
    assert verdict.pop("program"), readings
    expected = {"control_tf32"} | ({"fault_half_batch"} if kind == "train" else set())
    assert set(verdict) == expected
    for side, correct in verdict.items():
        assert not correct, (side, readings[side])
