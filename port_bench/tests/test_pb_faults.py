"""Whole runs on the CPU at a small size, the look for a card skipped, with
the timed path broken underneath: `correct` comes out false for each fault
a cell can have, under the cell's own limits, and true for the sound
program. The small model runs in f32 here, so that the sound run's gaps are
f32 rounding and every reading above it is the fault's.

Faults: a train step that returns its state unchanged (parameters, AdamW's
moments and count restored after the step); half of the batch left out,
the loss the mean over the rest; a served answer altered where it is made
(each instance's class moved by one). The exchange between chips has no
fault here: no cell of this benchmark spans chips.

The control, the reference in the precision below the configuration's in
the program's place, comes out not correct too: for training, the whole
step in fp8 against the limits (`calibrate.train_readings`). The serving
control (TF32 products) needs a card: `test_pb_cuda.py`.
"""

import copy
import time

import pytest

from port_bench import calibrate, check, harness
from port_bench.tests.tiny import cpu_threads, tiny_cell

SEED = 2 ** 35 + 3


def setup_module(module):
    cpu_threads()


def f32_cell(workload):
    c = tiny_cell(workload)
    conf = copy.deepcopy(c.config)
    if c.mix["driver"] == "train":
        conf["train_overrides"] = {**conf["train_overrides"], "model.dtype": "float32"}
        conf["train_precision"] = "float32"
    c.config = conf
    return c


def run(c):
    return harness.run_cell(c, SEED, 0.5, False, "cpu", time.perf_counter())


def state_unchanged(orig):
    def step(self, batch, points=None, mark=None):
        saved = copy.deepcopy(self.state_dict())
        out = orig(self, batch, points, mark)
        self.load_state_dict(saved)
        return out
    return step


def half_batch(orig):
    def step(self, batch, points=None, mark=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        pts = None if points is None else {k: v[:, : v.shape[1] // 2] for k, v in points.items()}
        return orig(self, half, pts, mark)
    return step


def answer_altered(orig):
    def infer(self, image):
        out = orig(self, image)
        out["instances"]["labels"] = (out["instances"]["labels"] + 1) % self.cfg.model.num_classes
        return out
    return infer


TRAIN = ["r50_train_mask", "boxsup_train"]


@pytest.mark.parametrize("workload", TRAIN + ["r50_serve"])
def test_sound_run_is_correct(workload):
    r = run(f32_cell(workload))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", TRAIN)
def test_train_fault_is_not_correct(workload, fault, monkeypatch):
    from bm2f_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "step", fault(Trainer.step))
    r = run(f32_cell(workload))
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(monkeypatch):
    from bm2f_tpu_torch.predict import Predictor

    monkeypatch.setattr(Predictor, "infer", answer_altered(Predictor.infer))
    r = run(f32_cell("r50_serve"))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_fp8_control_is_not_correct(workload):
    c = tiny_cell(workload)
    drv = harness.DRIVERS["train"](c, SEED, "cpu")
    readings = dict(calibrate.train_readings(drv, True))
    ok, rows = check.judge(readings["control_fp8"], c.limits)
    assert not ok, rows
