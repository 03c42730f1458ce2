"""The train entry point of the port under `torch.distributed.run
--nproc-per-node 2 ... --distributed --device cpu` (gloo): rank-0 writers
and checkpoints, a checkpoint from world 2 resumed at world 1 and the
other way round, `--eval-only` gathering both ranks' images, and
`--profile`'s trace. A tiny model (depth-14 ResNet, 2 encoder and 2
decoder layers, 10 queries) on 64x64 synthetic batches, as
tests/test_torch_train_data.py. Tolerances: `torch_ddp_cases`
(WORLD_REL: the order of sums between world sizes)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import write_synthetic_coco
from bm2f_tpu_torch.train import __main__ as train_main
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from test_torch_train_data import SIZES, TINY
from torch_ddp_cases import WORLD_REL, free_port

ROOT = Path(__file__).resolve().parent.parent
CONFIG = "coco_instance_r50"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    write_synthetic_coco(str(root), sizes=SIZES, seed=1)
    register_all_builtin_datasets(str(root), force=True)
    return root


def _sets(over):
    return [a for k, v in over.items() for a in ("--set", f"{k}={v!r}")]


def _base(out):
    over = {**TINY, "train.log_period": 1, "train.checkpoint_period": 1}
    return ["--config", CONFIG, "--device", "cpu", "--synthetic", "--size", "64",
            "--batch", "2", "--instances", "3", "--output", str(out)] + _sets(over)


def _launch(nproc, args, timeout=240):
    """`python -m torch.distributed.run --nproc-per-node nproc -m
    bm2f_tpu_torch.train --distributed args`; its stdout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "bm2f_tpu_torch.train", "--distributed"] + args
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-5000:])
    return res.stdout


def _lines(out):
    return [json.loads(ln) for ln in (Path(out) / "metrics.json").read_text().splitlines()]


def _eval_line(stdout):
    evals = [json.loads(ln[5:]) for ln in stdout.splitlines() if ln.startswith("eval ")]
    assert len(evals) == 1, stdout
    return evals[0]


@pytest.fixture(scope="module")
def world2_run(data_root, tmp_path_factory):
    """2 steps of the entry point over 2 gloo ranks, a checkpoint each step,
    then `--eval-only --resume` over 2 ranks."""
    out = tmp_path_factory.mktemp("world2")
    train_out = _launch(2, _base(out) + ["--max-iter", "2"])
    eval_out = _launch(2, _base(out) + ["--eval-only", "--resume", "--eval-dataset",
                                        "coco_2017_val", "--data-root", str(data_root)])
    return out, train_out, eval_out


def test_world2_entry_point_writes_once_from_rank_0(world2_run):
    out, stdout, _ = world2_run
    assert stdout.count("training done at iter 2") == 1, stdout
    assert [ln["iteration"] for ln in _lines(out)] == [1, 2]
    assert Checkpointer(str(out / "checkpoints")).all_steps() == [1, 2]
    assert not list(out.glob("checkpoints/.*tmp"))


@pytest.fixture(scope="module")
def world1_run(tmp_path_factory):
    """The same 2 steps uninterrupted in this process."""
    out = tmp_path_factory.mktemp("world1")
    assert train_main.main(_base(out) + ["--max-iter", "2"]) == 0
    return out


def _check_resumed(resumed, plain):
    """`resumed`, a run resumed at step 1 for step 2, against `plain`, the
    uninterrupted one: step 2's losses and grad_norm within WORLD_REL (the
    JSON lines are means over the run's steps: the uninterrupted run's
    step 2 is 2 line_2 - line_1), and the same step and generator state
    (each rank draws the global batch's points)."""
    (got,), (l1, l2) = _lines(resumed), _lines(plain)
    assert got["iteration"] == 2
    for k in got:
        if k.startswith("loss_") or k in ("total_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], 2 * l2[k] - l1[k], rtol=WORLD_REL, atol=1e-6,
                                       err_msg=k)
    sa = torch.load(resumed / "checkpoints" / "2" / "state.pt", weights_only=True)
    sb = torch.load(plain / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert sa["step"] == sb["step"] == 2
    assert torch.equal(sa["generator"], sb["generator"])


def test_world2_checkpoint_resumes_at_world_1(world2_run, world1_run, tmp_path, capsys):
    """World 2's checkpoint at step 1, resumed in one process for step 2,
    against the uninterrupted run in one process (`_check_resumed`); world
    2's own step 2 ends in the same generator state."""
    out = world2_run[0]
    resumed = tmp_path / "resumed"
    shutil.copytree(out / "checkpoints" / "1", resumed / "checkpoints" / "1")
    assert train_main.main(_base(resumed) + ["--max-iter", "2", "--resume"]) == 0
    assert "resumed from step 1" in capsys.readouterr().out
    _check_resumed(resumed, world1_run)
    s2 = torch.load(out / "checkpoints" / "2" / "state.pt", weights_only=True)
    s1 = torch.load(world1_run / "checkpoints" / "2" / "state.pt", weights_only=True)
    assert torch.equal(s2["generator"], s1["generator"])


def test_world1_checkpoint_resumes_at_world_2(world1_run, tmp_path):
    """And the other way round: one process's checkpoint at step 1 resumed
    over 2 gloo ranks for step 2."""
    resumed = tmp_path / "resumed"
    shutil.copytree(world1_run / "checkpoints" / "1", resumed / "checkpoints" / "1")
    stdout = _launch(2, _base(resumed) + ["--max-iter", "2", "--resume"])
    assert stdout.count("resumed from step 1") == 1, stdout
    _check_resumed(resumed, world1_run)


def test_world2_eval_only_gathers_both_ranks_images(world2_run, data_root, capsys):
    """`--eval-only` over 2 ranks (the 3 images split 2 and 1) prints one
    result, the one process's on the same checkpoint."""
    out, _, eval_out = world2_run
    got = _eval_line(eval_out)
    assert train_main.main(_base(out) + ["--eval-only", "--resume", "--eval-dataset",
                                         "coco_2017_val", "--data-root", str(data_root)]) == 0
    want = _eval_line(capsys.readouterr().out)
    assert got.keys() == want.keys() and got["iteration"] == 2 and "eval/AP" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)


def test_profile_traces_steps_10_to_15(tmp_path):
    """`--profile`: a `torch.profiler` trace of steps 10-15 in
    <output>/profile, in Chrome's format, with the step's ops and spans in
    it, and those steps' spans beside it."""
    over = {**TINY, "model.pixel_decoder.transformer_enc_layers": 1,
            "model.decoder.dec_layers": 1, "model.loss.train_num_points": 16}
    args = ["--config", CONFIG, "--device", "cpu", "--synthetic", "--size", "32", "--batch",
            "1", "--instances", "2", "--output", str(tmp_path), "--max-iter", "16",
            "--profile"] + _sets(over)
    assert train_main.main(args) == 0
    trace, spans = sorted((tmp_path / "profile").iterdir(), key=lambda p: p.name)
    assert (trace.name, spans.name) == ("rank0.pt.trace.json", "rank0.spans.json")
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any(n.startswith("aten::convolution") for n in names)
    assert sum(n.startswith("aten::_foreach_add_") for n in names) >= 1
    assert {"train.step", "train.backward", "assign.solve"} <= names
    roots = json.loads(spans.read_text())
    assert [r["name"] for r in roots] == ["train.step"] * 5
    assert all(r["counters"]["targets.slots"] == 2 for r in roots)
