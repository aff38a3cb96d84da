"""The comparison that decides ``correct`` fails what it must: runs of the
harness (its look for a card skipped, on the CPU at a tiny size) with the
timed path broken underneath, and with the control, the plain reference
computed in fp8, in the program's place. On the card the control runs at
the cell's own size."""

import pytest
import torch

from benchmark import harness
from benchmark.reference.model import round_to
from benchmark.system import Program, Reference

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5


class Unchanged(Program):
    """A train step that returns its state unchanged: no update."""

    def __init__(self, *args):
        super().__init__(*args)
        opt = self.state.optimizer.optimizer
        opt.step = lambda closure=None: opt.init_state()


class HalfBatch(Program):
    """Half of each batch left out, the mean taken over the rest."""

    def train_step(self, img, gt, compiled=None):
        h = img.shape[0] // 2
        return super().train_step(img[:h], gt[:h], compiled)

    def eval_step(self, imgs, compiled=None):
        h = imgs.shape[0] // 2
        out = super().eval_step(imgs[:h], compiled)
        return torch.cat([out, out])


def altered(scores):
    """One answer altered where it is produced."""
    scores = scores.clone()
    s = scores[0, 0]
    scores[0, 0] = s - 0.25 if s > 0.5 else s + 0.25
    return scores


class Altered(Program):
    def eval_step(self, imgs, compiled=None):
        return altered(super().eval_step(imgs, compiled))

    def predict(self, img, compiled=None):
        return altered(super().predict(img, compiled))


def readings(spec, cell, make):
    r = harness.run_cell(spec, cell, SEED, 0.0, False, CPU, make_system=make)
    return r["correct"], r["_readings"]


@pytest.mark.parametrize("cell,fault", [
    ("s576-train-b16", Unchanged), ("s576-train-b16", HalfBatch),
    ("s576-eval-b16", HalfBatch), ("s576-eval-b16", Altered),
    ("s576-serve-b1", Altered)])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    _, sound = readings(tiny, cell, Program)
    correct, broken = readings(tiny, cell, fault)
    assert not correct
    assert any(broken[k] > sound[k] for k in harness.limits(cell))


@pytest.mark.parametrize("cell", ["s576-train-b16", "s576-eval-b16"])
def test_control_reads_above_the_program(tiny, cell):
    _, sound = readings(tiny, cell, Program)
    _, control = readings(tiny, cell,
                          lambda *a: Reference(*a, cast=round_to("fp8")))
    assert any(control[k] > 3 * sound[k] for k in harness.limits(cell))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["s576-eval-b16", "s576-train-b16"])
def test_control_fails_at_the_cells_size(cell):
    """The control in the program's place at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = harness.load_spec()
    r = harness.run_cell(spec, cell, SEED, 0.5, False,
                         torch.device("cuda", 0),
                         make_system=lambda *a: Reference(
                             *a, cast=round_to("fp8")))
    assert not r["correct"]
