"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a small size (the
harness's look for a card skipped), with a fault planted in the
program's learner: a step that returns its state unchanged, half of
each batch left out with the mean taken over the rest, or an optimizer
that moves each parameter 30% too far. One chip and no answers to
alter: the cells have no exchange between chips and no tokens."""

import time

import pytest
import torch

from cellbench import run as run_mod
from cellbench.loops import learn
from cellbench.lookup import Cell
from cellbench.reference.step import half_batch

CELLS = ["impala_learn_b256"]


def _run(name, hook=None, seed=2 ** 33 + 5):
    cell = Cell(name)
    cell.traffic = dict(cell.traffic, unroll=5, batch=4, done_rate=0.1)
    rec, found, peak = learn.run(cell, seed, 0.3, False, "cpu",
                                 time.perf_counter(), learner_hook=hook)
    line, _ = run_mod.result(cell, rec, found, peak, False, "cpu")
    return cell, found, line


def _unchanged(learner):
    learner.apply_step = lambda state, grads: state


def _half(learner):
    grad_step = learner.grad_step

    def halved(model, batch):
        b = half_batch(batch)
        b["core_state"] = ()
        return grad_step(model, b)

    learner.grad_step = halved


def _overshoot(learner):
    apply_step = learner.apply_step

    def overshot(state, grads):
        before = [p.detach().clone() for p in state.model.parameters()]
        state = apply_step(state, grads)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.add_(0.3 * (p - b))
        return state

    learner.apply_step = overshot


def _failed(line):
    return {k for k, v in line["check"].items()
            if v["value"] is None or not v["value"] <= v["limit"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name):
    cell, found, line = _run(name, _unchanged)
    assert line["correct"] is False
    # No moment and no change: both leaf numbers read exactly 1.
    assert found["grad_gap"] == pytest.approx(1.0)
    assert found["change_gap"] == pytest.approx(1.0)
    assert {"grad_gap", "change_gap"} <= _failed(line)


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(name):
    _, sound, _ = _run(name)
    cell, found, line = _run(name, _half)
    assert line["correct"] is False
    assert found["policy_grad_noise"] > 3 * sound["policy_grad_noise"]
    assert "policy_grad_noise" in _failed(line)


@pytest.mark.parametrize("name", CELLS)
def test_an_optimizer_that_moves_too_far_is_not_correct(name):
    _, sound, sound_line = _run(name)
    cell, found, line = _run(name, _overshoot)
    assert line["correct"] is False
    assert "update_gap" not in _failed(sound_line)
    assert found["update_gap"] == pytest.approx(0.3, rel=0.05)
    assert "update_gap" in _failed(line)
    # The gradients are the sound run's: only the update is at fault.
    assert found["median_grad_noise"] == pytest.approx(
        sound["median_grad_noise"])


def test_the_window_counts_non_finite_losses():
    def poison(learner):
        grad_step = learner.grad_step

        def nan_loss(model, batch):
            grads, metrics = grad_step(model, batch)
            metrics["total_loss"] = metrics["total_loss"] * float("nan")
            return grads, metrics

        learner.grad_step = nan_loss

    _, found, line = _run("impala_learn_b256", poison)
    assert found["nonfinite_losses"] == line["attempted"] > 0
    assert line["failed"] == line["attempted"]
    assert line["correct"] is False


def test_state_unchanged_reads_one_without_a_run():
    """The upper reading a state left unchanged gives needs no run."""
    from cellbench import check

    ref = {"losses": [1.0], "loss_scales": [1.0],
           "grad1": {"policy.weight": torch.ones(3), "b": torch.ones(2)},
           "delta": {"policy.weight": torch.ones(3), "b": torch.ones(2)}}
    prog = check.unchanged(dict(ref, moments=[ref["grad1"]]))
    assert not any(v.any() for m in prog["moments"] for v in m.values())
    assert check.worst_leaf_gap(prog["grad1"], ref["grad1"]) == 1.0
    assert check.worst_leaf_gap(prog["delta"], ref["delta"]) == 1.0
