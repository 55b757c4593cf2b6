"""The control and each fault of the timed path come out not correct:
the run is driven as on the card, with its look for a chip skipped."""
import pytest
import torch

from perfbench import cells, dataset, faults, judge, run
from perfbench.tests.helpers import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bfloat16_control_is_not_correct(seed):
    cell = tiny_cell()
    ref = cells.reference(cell.config)
    code = run.code_of(ref, cell.config, cell.traffic)
    conf, tr = cell.config, cell.traffic
    x, y = dataset.make(seed, conf["m"], conf["d"], tr["classes"],
                        tr["sparsity"], tr["margin"], CPU)
    out = judge.control_outputs(ref, code, x, y, seed, torch.bfloat16)
    numbers = judge.judge(ref, code, x, y, out)
    assert not judge.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_in_the_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        res = run.run_cell(tiny_cell(), 23, 0.05, False, CPU, 0.0)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0


def test_faults_are_removed_after_use():
    res = run.run_cell(tiny_cell(), 23, 0.05, False, CPU, 0.0)
    assert res["correct"], res["checks"]
