"""``correct`` comes out false for the control and for every fault a cell
can have, and true for the system as it is: whole runs of the harness on
the CPU at a small size (the card's check skipped), each cell's own
limits. At the cells' own sizes on the card: ``-m card``."""

import pytest

from portbench import calibrate, cells, faults, judge, run
from portbench.tests.conftest import SMALL

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


def _small(workload):
    cell = cells.load(workload)
    cell.traffic = {**cell.traffic, "program": {**cell.traffic["program"], **SMALL}}
    return cell


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_system_as_it_is_is_correct(workload):
    result = run.run(workload, 21, 0.0, False, device="cpu", overrides=SMALL)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_fault_is_not_correct(workload, fault):
    with faults.planted(fault):
        result = run.run(workload, 22, 0.0, False, device="cpu", overrides=SMALL)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = _small(workload)
    numbers = calibrate.control_reading(cell, 23, "cpu")["numbers"]
    correct, checks = judge.decide(numbers, cell.limits["checks"])
    assert not correct, checks


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_on_the_card_at_the_cells_size(card, workload):
    cell = cells.load(workload)
    limits = cell.limits["checks"]
    program = calibrate.reading(cell, 24, "cuda")["numbers"]
    control = calibrate.control_reading(cell, 25, "cuda")["numbers"]
    assert judge.decide(program, limits)[0], program
    assert not judge.decide(control, limits)[0], control
