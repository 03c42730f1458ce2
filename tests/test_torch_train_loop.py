"""The port's training loop, checkpoints and event writers, on the CPU: the
counterparts of the JAX package's `run_train_loop` (train.py:40-147, held by
tests/test_train_loop.py), `Checkpointer` (bm2f_tpu/train/checkpoint.py) and
`utils/events.py`.

- the loop's accounting is exact: every iteration's metrics recorded in
  order, equal to a synchronous replay; writers fire at `log_period`;
  checkpoints land on `checkpoint_period` and at the end; the JSON lines
  carry the JAX package's keys;
- a run stopped and resumed from its checkpoint equals an uninterrupted one
  bit for bit (parameters, FrozenBN buffers, AdamW moments and count, the
  criterion generator);
- the entry point trains, saves and resumes;
- the port's JSONWriter writes what the JAX package's writes.

A tiny model (depth-14 ResNet, 2 encoder and 2 decoder layers, 10 queries,
128 points) on 64x64 images, so that a step takes well under a second."""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
from bm2f_tpu.losses.criterion import set_criterion as jax_set_criterion
from bm2f_tpu.utils import events as jax_events
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.train.loop import ASYNC_DEPTH, run_train_loop, synthetic_loader
from bm2f_tpu_torch.train.trainer import Trainer
from bm2f_tpu_torch.utils import events
from torch_port_utils import SMALL

TINY = {**SMALL, "model.decoder.dec_layers": 2, "model.loss.train_num_points": 128,
        "train.optimizer.warmup_iters": 3, "train.optimizer.warmup_factor": 0.5}
BATCH = dict(batch=2, size=64, instances=3, seed=4)


def _cfg(**train):
    return get_config("coco_instance_r50",
                      {**TINY, **{f"train.{k}": v for k, v in train.items()}})


class _RecordingWriter:
    """(step, latest total_loss) at every log_period boundary, as
    tests/test_train_loop.py records them."""

    def __init__(self, log_period):
        self.log_period = log_period
        self.rows = []

    def write(self, storage):
        if storage.step % self.log_period == 0:
            self.rows.append((storage.step, storage.latest()["total_loss"]))


def _jax_loss_keys(n_layers: int) -> set:
    """The loss keys the JAX `set_criterion` gives for n_layers layers."""
    rng = np.random.RandomState(0)
    B, Q, K, G = 1, 4, 3, 2
    out = {"pred_logits": rng.randn(B, Q, K + 1), "pred_masks": rng.randn(B, Q, 8, 8),
           "aux_logits": rng.randn(n_layers - 1, B, Q, K + 1),
           "aux_masks": rng.randn(n_layers - 1, B, Q, 8, 8)}
    tgt = {"labels": np.zeros((B, G), np.int32), "masks": np.ones((B, G, 16, 16)),
           "valid": np.ones((B, G), bool)}
    _, losses = jax_set_criterion(
        {k: jnp.asarray(v, jnp.float32) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in tgt.items()},
        JaxCriterionConfig(num_classes=K, num_points=16), jax.random.PRNGKey(0))
    return set(losses)


def test_run_train_loop_accounting_is_exact(tmp_path):
    """9 iterations, log_period 6, checkpoint_period 7: more than
    ASYNC_DEPTH steps are in flight before the first pull; the recorded
    losses equal a synchronous replay's bitwise; the writers fire at 6 only;
    checkpoints at 7 and the forced 9; the JSON lines hold the JAX keys."""
    cfg = _cfg(log_period=6, checkpoint_period=7, **{"optimizer.max_iter": 9})
    assert cfg.train.log_period > ASYNC_DEPTH
    batch = next(synthetic_loader(**BATCH))
    replay_trainer = Trainer(cfg, device="cpu", seed=1)
    replay = [replay_trainer.step({k: torch.from_numpy(v) for k, v in batch.items()})
              ["total_loss"].item() for _ in range(9)]

    trainer = Trainer(cfg, device="cpu", seed=1)
    storage = events.EventStorage(window=20)
    rec = _RecordingWriter(cfg.train.log_period)
    json_path = tmp_path / "metrics.json"
    writers = [rec, events.JSONWriter(str(json_path), cfg.train.log_period)]
    ckpt = Checkpointer(str(tmp_path / "ck"))
    it = run_train_loop(cfg, trainer, itertools.cycle([batch]), batch, ckpt, storage,
                        writers)

    assert it == trainer.step_count == 9
    hist = list(storage._hist["total_loss"])
    assert storage.step == 9 and hist == replay
    assert rec.rows == [(6, replay[5])]
    assert ckpt.all_steps() == [7, 9]
    lines = [json.loads(ln) for ln in json_path.read_text().splitlines()]
    assert [ln["iteration"] for ln in lines] == [6]
    want = {"iteration", "total_loss", "grad_norm", "lr", "eta_hours"} | _jax_loss_keys(3)
    assert set(lines[0]) == want
    # the writers' values are means over the storage's window, as in JAX
    assert lines[0]["lr"] == pytest.approx(np.mean([trainer.optimizer.schedule(i)
                                                    for i in range(1, 7)]), rel=1e-12)
    assert lines[0]["total_loss"] == pytest.approx(np.mean(replay[:6]), rel=1e-12)


def _run(cfg, trainer, ckpt):
    loader = synthetic_loader(**BATCH, start=trainer.step_count)
    return run_train_loop(cfg, trainer, loader, next(loader), ckpt,
                          events.EventStorage(), [])


def _assert_states_equal(a, b):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    for key in ("mu", "nu"):
        for k in a["optimizer"][key]:
            assert torch.equal(a["optimizer"][key][k], b["optimizer"][key][k]), (key, k)
    assert torch.equal(a["generator"], b["generator"])


def test_resumed_run_equals_uninterrupted_run_bitwise(tmp_path):
    """4 iterations in one run, against 2, a fresh trainer resumed from the
    checkpoint at 2 (as `--resume` does), and 2 more: the whole state is
    bitwise equal."""
    whole = Trainer(_cfg(checkpoint_period=2, **{"optimizer.max_iter": 4}), "cpu", seed=2)
    assert _run(whole.cfg, whole, Checkpointer(str(tmp_path / "whole"))) == 4

    ck = Checkpointer(str(tmp_path / "parts"))
    first = Trainer(_cfg(checkpoint_period=2, **{"optimizer.max_iter": 2}), "cpu", seed=2)
    assert _run(first.cfg, first, ck) == 2
    assert ck.all_steps() == [2]
    second = Trainer(_cfg(checkpoint_period=2, **{"optimizer.max_iter": 4}), "cpu", seed=2)
    assert ck.resume_or_load(second, resume=True) == 2 and second.step_count == 2
    _assert_states_equal(second.state_dict(), first.state_dict())
    assert _run(second.cfg, second, ck) == 4
    _assert_states_equal(second.state_dict(), whole.state_dict())


def test_checkpointer_keeps_the_newest_and_restores_bitwise(tmp_path):
    """max_to_keep prunes the oldest; a step on disk is kept unless forced;
    `restore` loads the latest, or the one asked for; resume_or_load leaves
    a fresh trainer alone without a checkpoint or without `resume`."""
    trainer = Trainer(_cfg(), "cpu", seed=3)
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(trainer)
    assert ck.resume_or_load(trainer, resume=True) is None
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for step in (1, 2, 3):
        assert ck.save(step, trainer)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    with torch.no_grad():
        trainer.model.sem_seg_head.predictor.class_embed.weight.add_(1.0)
    assert not ck.save(3, trainer)  # already on disk
    fresh = Trainer(_cfg(), "cpu", seed=4)
    assert ck.resume_or_load(fresh, resume=False) is None
    assert ck.restore(fresh) == 3
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert ck.save(3, trainer, force=True)
    assert ck.restore(fresh, step=3) == 3
    assert torch.equal(fresh.model.sem_seg_head.predictor.class_embed.weight,
                       trainer.model.sem_seg_head.predictor.class_embed.weight)


def test_entry_point_trains_saves_and_resumes(tmp_path, capsys):
    """`python -m bm2f_tpu_torch.train --synthetic --max-iter 2`, then
    `--resume --max-iter 3`: checkpoints at 1, 2 and 3, the JSON lines of
    every step, and the resumed run starting from 2."""
    args = ["--device", "cpu", "--synthetic", "--size", "64", "--batch", "2",
            "--instances", "3", "--output", str(tmp_path)]
    for k, v in {**TINY, "train.log_period": 1, "train.checkpoint_period": 1}.items():
        args += ["--set", f"{k}={v!r}"]
    assert train_main.main(args + ["--max-iter", "2"]) == 0
    assert train_main.main(args + ["--max-iter", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "training done at iter 3" in out
    assert Checkpointer(str(tmp_path / "checkpoints")).all_steps() == [1, 2, 3]
    lines = [json.loads(ln) for ln in (tmp_path / "metrics.json").read_text().splitlines()]
    assert [ln["iteration"] for ln in lines] == [1, 2, 3]
    with pytest.raises(SystemExit):
        train_main.main(args + ["--max-iter", "3", "--steps", "1"])


def test_json_writer_writes_what_the_jax_writer_writes(tmp_path):
    """The same scalars through the port's EventStorage and JSONWriter and
    through the JAX package's give the same lines."""
    rng = np.random.RandomState(0)
    paths = {}
    for name, mod in (("port", events), ("jax", jax_events)):
        storage = mod.EventStorage(window=3)
        paths[name] = tmp_path / f"{name}.json"
        writer = mod.JSONWriter(str(paths[name]), log_period=2)
        for step in range(1, 8):
            storage.put_scalars(step, total_loss=float(rng.rand()), loss_ce_0=step * 0.5,
                                lr=1e-4, eta_hours=0.1 / step)
            writer.write(storage)
        rng = np.random.RandomState(0)
    assert paths["port"].read_text() == paths["jax"].read_text()
    assert len(paths["port"].read_text().splitlines()) == 3
