"""The control -- the plain reference put in the program's place and
computed in the precision below the configuration's (TF32 for float32,
scaled fp8 for bfloat16) -- comes out not correct under each cell's
limits, at a tiny size on the CPU.  (On the card, at the cells' own sizes,
``portbench/control.py`` reads it.)"""
import json

import pytest

from portbench import check, harness
from portbench.conftest import tiny_cell
from portbench.control import control_readings

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    (kind, nums), = control_readings(cell, 2**31 + 3, ["control"], device="cpu")
    assert kind == "control"
    assert not check.judge(nums, cell.limits), nums
