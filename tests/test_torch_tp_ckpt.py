"""Checkpoints and evaluation under tensor parallelism: `Trainer.state_dict`
gathers the shares of the parameters and of both AdamW moments, so that a
checkpoint is the same file whatever `mesh.model` is. A checkpoint written
at mesh (1, 2) (two gloo ranks) resumes in one process bitwise, and one
written in one process resumes at (1, 2) bitwise (each rank holding its
shares of the file's tensors); `Trainer.eval_model` is a whole model on the
gathered weights. Then the entry point under `torch.distributed.run
--nproc-per-node 2 ... --set mesh.model=2`: rank 0's checkpoints, the
evaluation on the gathered weights against one process's on the same
checkpoint, and the checkpoint resumed in one process."""

import json
import math

import numpy as np
import torch

from bm2f_tpu.config import InputConfig as JaxInputConfig
from bm2f_tpu.data import loader as jax_loader
from bm2f_tpu.data import mappers as jax_mappers
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from test_torch_ddp_entry import _base, _eval_line, _launch, _lines, data_root  # noqa: F401
from test_torch_train_data import TINY
from torch_ddp_cases import run_ranks
from torch_port_utils import SMALL

CONFIG = "coco_instance_r50"
TP = {**SMALL, "mesh.model": 2}


def differing(a, b) -> list:
    """The entries where two `Trainer.state_dict()`s differ in any bit."""
    bad = [k for k in ("step",) if a[k] != b[k]]
    bad += [f"model.{k}" for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    for m in ("mu", "nu"):
        bad += [f"{m}.{k}" for k in a["optimizer"][m]
                if not torch.equal(a["optimizer"][m][k], b["optimizer"][m][k])]
    bad += [k for k in ("count",) if a["optimizer"][k] != b["optimizer"][k]]
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    return bad


def _saved(directory):
    ckpt = Checkpointer(directory)
    return torch.load(ckpt.directory / str(ckpt.latest_step()) / STATE_FILE,
                      weights_only=True)


def _batch():
    return synthetic_batch(2, 64, 4, seed=3, device="cpu")


def _tp_save_and_resume(t2_dir, t1_dir):
    """In each rank at (1, 2): a step, saved into `t2_dir`; then a fresh
    trainer (another seed) resumed from `t1_dir`'s one-process checkpoint.
    Returns what differs from the file: the gathered state, the rank's
    shares, the whole eval model's weights."""
    trainer = Trainer(get_config(CONFIG, TP), device="cpu")
    trainer.step(_batch())
    Checkpointer(t2_dir).save(trainer.step_count, trainer)
    fresh = Trainer(get_config(CONFIG, TP), device="cpu", seed=1)
    step = Checkpointer(t1_dir).resume_or_load(fresh)
    saved = _saved(t1_dir)
    shares = tparallel.shard_state(saved["model"], fresh.splits, fresh.shard.rank,
                                   fresh.shard.size)
    local = fresh.model.state_dict()
    whole = fresh.eval_model().state_dict()
    return {"step": step, "gathered": differing(fresh.state_dict(), saved),
            "shares": [k for k in local if not torch.equal(local[k], shares[k])],
            "eval_model": [k for k in whole if not torch.equal(whole[k], saved["model"][k])],
            "split_shapes": {k: tuple(local[k].shape) for k in fresh.splits}}


def test_checkpoints_resume_across_model_sizes(tmp_path):
    t1_dir, t2_dir = str(tmp_path / "t1"), str(tmp_path / "t2")
    one = Trainer(get_config(CONFIG, SMALL), device="cpu")
    one.step(_batch())
    Checkpointer(t1_dir).save(one.step_count, one)
    got = run_ranks(_tp_save_and_resume, 2, t2_dir, t1_dir)
    for res in got:
        assert res["step"] == 1
        assert res["gathered"] == res["shares"] == res["eval_model"] == [], res
    saved1 = _saved(t1_dir)
    for k, shape in got[0]["split_shapes"].items():
        full = saved1["model"][k].shape
        assert shape != tuple(full) and math.prod(shape) * 2 == full.numel(), k
    fresh = Trainer(get_config(CONFIG, SMALL), device="cpu", seed=1)
    assert Checkpointer(t2_dir).resume_or_load(fresh) == 1
    assert differing(fresh.state_dict(), _saved(t2_dir)) == []


def test_tp_entry_point_checkpoints_eval_and_resume(data_root, tmp_path, capsys):  # noqa: F811
    """2 steps at mesh (1, 2) under the launcher, `--eval-only --resume` at
    (1, 2) against one process's on the same checkpoint (the same metrics:
    the same weights, gathered), then the checkpoint continued in one
    process to step 3."""
    out = tmp_path / "tp"
    tp_sets = ["--set", "mesh.model=2"]
    _launch(2, _base(out) + tp_sets + ["--max-iter", "2"])
    assert Checkpointer(str(out / "checkpoints")).all_steps() == [1, 2]
    assert [ln["iteration"] for ln in _lines(out)] == [1, 2]
    ev = ["--eval-only", "--resume", "--eval-dataset", "coco_2017_val",
          "--data-root", str(data_root)]
    tp_eval = _eval_line(_launch(2, _base(out) + tp_sets + ev))
    capsys.readouterr()
    assert train_main.main(_base(out) + ev) == 0
    one_eval = json.loads(next(ln[5:] for ln in capsys.readouterr().out.splitlines()
                               if ln.startswith("eval ")))
    assert tp_eval == one_eval and tp_eval["iteration"] == 2
    assert train_main.main(_base(out) + ["--max-iter", "3", "--resume"]) == 0
    assert Checkpointer(str(out / "checkpoints")).latest_step() == 3


class _Args:
    synthetic, dataset = False, "coco_2017_val"


def test_tp_loaders_are_the_jax_per_host_loaders_by_data_rank(data_root, monkeypatch):  # noqa: F811
    """At mesh (2, 2) over 4 ranks the entry point's loader of rank r is
    the JAX package's per-host loader of data rank r // 2 of 2 (the ranks
    of a model group read the same images), ims_per_batch / 2 a step."""
    cfg = get_config(CONFIG, {**TINY, "train.ims_per_batch": 4, "input.max_instances": 4,
                              "mesh.model": 2})
    jcfg = JaxInputConfig(**{k.split(".", 1)[1]: v for k, v in TINY.items()
                             if k.startswith("input.")} | {"max_instances": 4})
    jax_register(str(data_root), force=True)
    monkeypatch.setattr(train_main, "world_size", lambda: 4)
    for r in range(4):
        monkeypatch.setattr(train_main, "rank", lambda: r)
        ours = train_main.train_loader(cfg, _Args, 0)
        ref = jax_loader.build_train_loader(
            "coco_2017_val", jax_mappers.MAPPERS[cfg.input.dataset_mapper](jcfg, seed=0), 2,
            seed=cfg.train.seed, rank=r // 2, world_size=2)
        a, b = next(ours), next(ref)
        assert a["images"].shape[0] == 2
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
