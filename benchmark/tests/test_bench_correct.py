"""The check that decides ``correct``, on tiny cells on the CPU: the
program's plain path agrees with the benchmark's reference for every mix,
and the comparison refuses the control (the reference in bfloat16 in the
program's place) and each fault a cell can have, planted underneath the
timed path: an answer altered where it is produced, a step that returns
its state unchanged, half of the batch left out with the mean over the rest,
a step gone wrong after set-up.  Each cell's session class plants its own
faults (``planted_faults``); cells are told apart by class.  One cell, one
card: there is no exchange between chips to leave out."""
import pytest

import tiny


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_program_agrees_with_the_reference(cell, trace):
    result, checks, _ = tiny.run(cell, trace=trace)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_in_bfloat16_is_refused(cell):
    result, checks, stand = tiny.run(cell, stand_ins=("bfloat16",))
    assert result["correct"]
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(v > limits[k] for k, v in stand["bfloat16"].items()), stand


def cells_planting(fault):
    """The cells whose session class plants ``fault``."""
    return [c for c in tiny.CELLS if fault in tiny.session_class(c).planted_faults()]


def planted(cell, fault, patch):
    """The cell's program with its session class's ``fault`` planted."""
    cls = tiny.session_class(cell)
    return cls.planted_faults()[fault](cls.load_program(), patch)


@pytest.mark.parametrize("cell", cells_planting("altered_answer"))
def test_altered_answer_is_refused(cell, monkeypatch):
    result, checks, _ = tiny.run(cell, program=planted(cell, "altered_answer",
                                                       monkeypatch.setattr))
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", cells_planting("unchanged_state"))
def test_step_that_leaves_its_state_is_refused(cell, monkeypatch):
    result, checks, _ = tiny.run(cell, program=planted(cell, "unchanged_state",
                                                       monkeypatch.setattr))
    assert not result["correct"], checks
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", cells_planting("half_batch"))
def test_half_the_batch_is_refused(cell, monkeypatch):
    result, checks, stand = tiny.run(cell, program=planted(cell, "half_batch",
                                                           monkeypatch.setattr),
                                     stand_ins=("half_batch",))
    assert not result["correct"], checks
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(v > limits[k] for k, v in stand["half_batch"].items()), stand


@pytest.mark.parametrize("cell", cells_planting("wrong_after_set_up"))
def test_a_step_gone_wrong_after_set_up_is_refused(cell, monkeypatch):
    """The first steps agree with the reference; the steps from the state
    the window ended in do not."""
    result, checks, _ = tiny.run(cell, program=planted(cell, "wrong_after_set_up",
                                                       monkeypatch.setattr))
    assert not result["correct"], checks
    first = ("loss_gap", "grad_gap", "change_gap")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in first), checks
    assert checks["change_gap.end"]["value"] > checks["change_gap.end"]["limit"], checks


NAMED = {"altered_answer", "unchanged_state", "half_batch", "wrong_after_set_up"}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_every_planted_fault_is_refused(cell, monkeypatch):
    """Every cell plants a fault, and each one that no test above names is
    refused too: a session of its own brings its faults by name."""
    faults = tiny.session_class(cell).planted_faults()
    assert faults
    for fault in sorted(set(faults) - NAMED):
        with monkeypatch.context() as mp:
            result, checks, _ = tiny.run(cell, program=planted(cell, fault, mp.setattr))
        assert not result["correct"], (fault, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_at_full_size_on_the_card(cell, cuda_device):
    import time

    from vrbench import harness

    result, checks, stand = harness.run_cell(tiny.BENCH, cell, 2147484100, 1.0, False,
                                             cuda_device, time.perf_counter(), quiet=True,
                                             stand_ins=("bfloat16",))
    assert result["correct"], checks
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(v > limits[k] for k, v in stand["bfloat16"].items()), stand
