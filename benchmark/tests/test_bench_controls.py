"""The controls: the reference put in the program's place one precision
below the configuration's must come out not correct under the cell's
limits, and so must the faults planted in it.  On the CPU at a tiny size
for training; on the card at the cell's own size for every cell
(``cuda``: skips without a card)."""

import pytest
import torch

from benchmark import controls
from benchmark.harness import registry
from benchmark.harness.env import BENCH

from .helpers import train_cell


def limits(workload):
    return registry.load_json(BENCH / "limits" / f"{workload}.json")


@pytest.mark.parametrize("kind", ["control", "half_batch"])
def test_training_control_and_fault_fail_at_a_tiny_size(kind):
    cell = train_cell("bfloat16", limits("train-b128"))
    checks = controls.train_case(cell, 2**31 + 17, torch.device("cpu"), kind,
                                 log=lambda m: None)
    assert not all(v <= lim for _, v, lim in checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-b128", "batch-b64-gl",
                                      "batch-b64-hifigan"])
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = registry.load_cell(workload)
    checks = controls.run_case(cell, 2**31 + 29, torch.device("cuda", 0),
                               "control", log=lambda m: None)
    assert not all(v <= lim for _, v, lim in checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["early_stop", "late_stop"])
@pytest.mark.parametrize("workload", ["batch-b64-gl", "batch-b64-hifigan"])
def test_a_stop_one_frame_off_fails_at_the_cells_size(workload, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault runs at the cell's size")
    cell = registry.load_cell(workload)
    checks = dict((n, (v, lim)) for n, v, lim in controls.run_case(
        cell, 2**31 + 31, torch.device("cuda", 0), kind, log=lambda m: None))
    value, limit = checks["stop_gap"]
    assert value > limit, checks
