"""The check that decides ``correct``, on tiny cells on the CPU: the
program's plain path agrees with the benchmark's reference for every mix,
and the comparison refuses the control (the reference in bfloat16 in the
program's place) and each fault a cell can have, planted underneath the
timed path: an answer altered where it is produced, a step that returns
its state unchanged, half of the batch left out with the mean over the rest.
One cell, one card: there is no exchange between chips to leave out."""
import types

import pytest
import torch

import tiny
from vrbench import traffic

RENDER_CELLS = [c for c in tiny.CELLS if not c.endswith("fit_views8")]
FIT_CELLS = [c for c in tiny.CELLS if c.endswith("fit_views8")]


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


def _altering(program):
    """The program with each render's answer altered where it is produced:
    an 8x8 tile of the image 0.05 darker."""

    def wrap(plan):
        render = plan.render

        def altered(*a, **k):
            rgb, aux = render(*a, **k)
            rgb = rgb.clone()
            rgb[:8, :8] -= 0.05
            return rgb, aux

        plan.render = altered
        return plan

    return types.SimpleNamespace(**{**vars(program),
                                    "plan_compositing": lambda *a, **k: wrap(
                                        program.plan_compositing(*a, **k)),
                                    "IsosurfacePlan": lambda *a, **k: wrap(
                                        program.IsosurfacePlan(*a, **k))})


@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_altered_answer_is_refused(cell):
    result, checks, _ = tiny.run(cell, program=_altering(traffic.load_program()))
    assert not result["correct"], checks


def _unchanged(program):
    """The program whose render passes no gradient: every step returns its
    state unchanged."""

    def make(plan):
        f = program.make_render_tf_voxel(plan)

        def g(params, vol):
            rgb, alpha = f(params, vol)
            return rgb - rgb + rgb.detach(), alpha

        return g

    return types.SimpleNamespace(**{**vars(program), "make_render_tf_voxel": make})


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_step_that_leaves_its_state_is_refused(cell):
    result, checks, _ = tiny.run(cell, program=_unchanged(traffic.load_program()))
    assert not result["correct"], checks
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_half_the_batch_is_refused(cell, monkeypatch):
    def half_frame(self, keep=None):
        h = self.target.shape[0] // 2
        rgb, _ = self.render(self.P.TFParams(*self.leaves), self.vol)
        loss = torch.mean((rgb[:h] - self.target[:h]) ** 2)
        grads = torch.autograd.grad(loss, [*self.leaves, self.vol])
        with torch.no_grad():
            for leaf, g in zip(self.leaves, grads[:-1]):
                leaf.sub_(self.lr["params"] * g)
            self.vol.sub_(self.lr["volume"] * grads[-1])
        self.loss = loss.detach()
        self.t += 1

    monkeypatch.setattr(traffic.FitSession, "frame", half_frame)
    result, checks, stand = tiny.run(cell, stand_ins=("half_batch",))
    assert not result["correct"], checks
    limits = {k: c["limit"] for k, c in checks.items()}
    assert any(v > limits[k] for k, v in stand["half_batch"].items()), stand


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_a_step_gone_wrong_after_set_up_is_refused(cell, monkeypatch):
    """A fault that appears only once the fit has run a while: from the
    window on, each step moves the volume twice as far.  The first steps
    agree with the reference; the steps from the state the window ended in
    do not."""
    frame = traffic.FitSession.frame

    def late_double(self, keep=None):
        before = self.vol.detach().clone()
        frame(self, keep)
        if self.t > self.steps:
            with torch.no_grad():
                self.vol.add_(self.vol - before)

    monkeypatch.setattr(traffic.FitSession, "frame", late_double)
    result, checks, _ = tiny.run(cell)
    assert not result["correct"], checks
    first = ("loss_gap", "grad_gap", "change_gap")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in first), checks
    assert checks["change_gap.end"]["value"] > checks["change_gap.end"]["limit"], checks


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
