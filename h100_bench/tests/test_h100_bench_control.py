"""`correct` comes out false for the control and for every fault a cell
can have, through the rest of a run at a tiny size on the CPU, against the
cell's own limits.

The control: the reference in the program's place, its products in fp8,
the precision below the configurations' bf16.  The faults: an answer
altered where it is produced (serving); a step that leaves its state
unchanged, and a step on half of its batch, the mean taken over the rest
(training).  The same control at the cells' own size on the card gives
the upper readings of PERF.md (`calibrate.py`)."""

import pytest
import torch

from h100_bench import cell_train, program, run
from h100_bench.reference import grl as ref
from h100_bench.tests.tiny import tiny_cell

SERVE = ["grl_s_x4.sr_256", "grl_base_x4.sr_256", "grl_s_x4.sr_assorted"]
TRAIN = "grl_base_x4.train_sr_p64"
SEEDS = [5, 2**31 + 3, 7 * 2**32 + 1]


class Fp8Reference(torch.nn.Module):
    """The reference forward with fp8 products, as the Restorer calls a model."""

    def __init__(self, P, m):
        super().__init__()
        self.P, self.m = P, m

    def forward(self, x):
        with ref.exact_fp32():
            return ref.forward(self.P, self.m, x, prec="fp8")


def correct(cell, seed):
    return run.execute(cell, seed, 0.3, False, "cpu", 0.0)["result"]["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", SERVE)
def test_serving_control_is_not_correct(workload, seed, monkeypatch):
    cell = tiny_cell(workload)
    monkeypatch.setattr(program, "grl", lambda c, P, device: Fp8Reference(P, c.model()))
    assert not correct(cell, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(seed, monkeypatch):
    cell = tiny_cell(TRAIN)
    monkeypatch.setattr(cell_train, "first_steps", lambda state, step, mix, data, P0:
                        cell_train.reference(cell, seed, data, torch.device("cpu"), "fp8"))
    assert not correct(cell, seed)


@pytest.mark.parametrize("workload", SERVE)
def test_an_altered_answer_is_not_correct(workload, monkeypatch):
    from grlir_torch.engines.inference import Restorer

    served = Restorer.__call__

    def altered(self, img):
        y = served(self, img)
        y[0, 0, 0, 0] += 0.25
        return y

    monkeypatch.setattr(Restorer, "__call__", altered)
    assert not correct(tiny_cell(workload), SEEDS[0])


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    build = cell_train.build

    def frozen(*a, **k):
        state, step = build(*a, **k)
        state.optimizer.step = lambda closure=None: None
        return state, step

    monkeypatch.setattr(cell_train, "build", frozen)
    assert not correct(tiny_cell(TRAIN), SEEDS[0])


def test_a_step_on_half_its_batch_is_not_correct(monkeypatch):
    build = cell_train.build

    def halved(*a, **k):
        state, step = build(*a, **k)

        def half_step(st, batch):
            return step(st, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

        return state, half_step

    monkeypatch.setattr(cell_train, "build", halved)
    assert not correct(tiny_cell(TRAIN), SEEDS[0])
