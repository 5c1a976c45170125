"""On the card, at each cell's own size: the control (the reference one
step below the configuration's precision, in the program's place) and
the half-batch fault come out not correct, each by the numbers it was
read to fail, and the program correct.

    python3 -m pytest cellbench/tests/test_cellbench_card.py -m cuda

They skip without a card."""

import pytest

from cellbench import calibrate
from cellbench.check import judge
from cellbench.lookup import Cell

CELLS = ["impala_learn_b256"]
#: What the control and half a batch fail, by the readings of the
#: cell's limits file (its "from").
CONTROL_FAILS = {"impala_learn_b256": {"policy_grad_noise",
                                       "median_grad_noise", "update_gap"}}
HALF_FAILS = {"impala_learn_b256": {"policy_grad_noise",
                                    "median_grad_noise"}}
SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def _failed(found, limits):
    """The compared numbers that fail their limits; every number the
    limits compare has to be there."""
    correct, table = judge(found, limits)
    assert all(v["value"] is not None for v in table.values()), table
    assert correct is (not any(v["value"] > v["limit"]
                               for v in table.values()))
    return {k for k, v in table.items() if v["value"] > v["limit"]}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name, seed):
    cell = Cell(name)
    found = calibrate.stand_in_numbers(cell, seed, card,
                                       cell.config["control"])
    found["nonfinite_losses"] = 0
    assert _failed(found, cell.limits) >= CONTROL_FAILS[name], found


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_is_not_correct(card, name):
    cell = Cell(name)
    found = calibrate.stand_in_numbers(cell, SEEDS[0], card,
                                       fault="half_batch")
    found["nonfinite_losses"] = 0
    assert _failed(found, cell.limits) >= HALF_FAILS[name], found


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(card, name):
    cell = Cell(name)
    found = calibrate.program_numbers(cell, SEEDS[1], card)
    found["nonfinite_losses"] = 0
    assert judge(found, cell.limits)[0] is True, found
