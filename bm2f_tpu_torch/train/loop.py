"""The training loop: the counterpart of the JAX package's `run_train_loop`
(root train.py:40-147), written, as it is, for asynchronous dispatch:

- no per-step device synchronise: the iteration counter is kept on the
  host (each `Trainer.step` adds exactly one);
- each step's metric scalars are stacked into ONE device vector at dispatch
  time, and the host pulls a vector only once it is `ASYNC_DEPTH` steps old
  (by then the device has long finished it); writers flush at `log_period`
  from the pulled rows;
- the next batch is uploaded while the current step runs on the device;
- a save every `train.checkpoint_period` steps and a forced save at the end;
- with an eval dataset, an evaluation every `train.eval_period` steps
  before the last (`dispatch_eval`, as at root train.py:127-145), its
  metrics put into the storage as `eval/<key>` and written at once.

The scalars carry `lr` and `eta_hours` as the JAX loop's do. With
`profile_dir`, steps 10-15 are traced with `torch.profiler` (root
train.py:109-125 traces them with `jax.profiler`).

Under data parallelism (`parallel/`) every rank runs this loop on its rows
of the global batch: the trainer's metrics are already the global ones,
the writers write on rank 0 only (`utils/events.py`), `ckpt.save` writes on
rank 0 while the others wait, and the evaluation runs on every rank on the
unwrapped model (a whole one on the gathered weights under tensor
parallelism, `Trainer.eval_model`), each on its shard of the dataset, and
gathers the evaluators (`eval.run_eval` takes the rank and world from the
group). The synthetic batches and the loader's shard go by the data rank:
the ranks of a model group train the same rows.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import torch

from bm2f_tpu_torch.parallel import local_rows, rank
from bm2f_tpu_torch.train.trainer import synthetic_batch
from bm2f_tpu_torch.utils import tracing

# how many dispatched-but-unpulled steps may be in flight (train.py:37)
ASYNC_DEPTH = 4
# the batch keys the step reads ("dino_feats" only where the mapper gives
# them: the temporal pairwise loss's DINO patch features)
BATCH_KEYS = ("images", "labels", "masks", "valid", "dino_feats")
# the iterations `--profile` traces (root train.py:109, :124)
PROFILE_STEPS = (10, 15)


def to_device(batch: Mapping[str, object], device: torch.device) -> dict:
    """The step's keys of a host batch (numpy arrays or CPU tensors) on
    `device`; from pinned memory and without blocking on the card, so that
    the copy overlaps the step in flight."""
    out = {}
    for k in (k for k in BATCH_KEYS if k in batch):
        t = torch.as_tensor(batch[k])
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def dispatch_eval(cfg, model, dataset: str) -> Dict[str, float]:
    """`eval.run_eval` of `model` on `dataset` (the evaluator its metadata
    names), or `eval_video.run_video_eval` (track AP) for a video config, as
    root train.py:230-234 dispatches; with the model in eval mode for the
    pass and back in train mode after. Draws from no generator of the
    trainer and touches no optimizer state, so that an eval mid-run leaves
    the training result as it was."""
    if cfg.task == "video":
        from bm2f_tpu_torch.eval_video import run_video_eval as run
    else:
        from bm2f_tpu_torch.eval import run_eval as run

    model.eval()
    try:
        return run(cfg, model, dataset)
    finally:
        model.train()


class StepProfiler:
    """A `torch.profiler` trace of the iterations `PROFILE_STEPS` (and of
    fewer when the run ends first), written to
    `<directory>/rank<r>.pt.trace.json` (Chrome's trace format), and the
    traced steps' spans and counters (`utils.tracing.records`) beside it, as
    `rank<r>.spans.json`."""

    def __init__(self, directory: str, device: torch.device):
        self.directory = directory
        self.device = device
        self.prof = None
        self.since = -1  # the last root traced before the profile

    def at(self, it: int) -> None:
        """Called with the iteration about to run and after the last."""
        if it == PROFILE_STEPS[0] and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.since = max((r["id"] for r in tracing.records()), default=-1)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif it >= PROFILE_STEPS[1]:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.prof.export_chrome_trace(
            os.path.join(self.directory, f"rank{rank()}.pt.trace.json"))
        with open(os.path.join(self.directory, f"rank{rank()}.spans.json"), "w") as f:
            json.dump([r for r in tracing.records() if r["id"] > self.since], f)
        self.prof = None


def run_train_loop(cfg, trainer, loader: Iterator[Mapping[str, object]],
                   first_batch: Mapping[str, object], ckpt, storage,
                   writers: Sequence, eval_dataset: str = "",
                   profile_dir: Optional[str] = None) -> int:
    """Steps `trainer` from its `step_count` to `cfg.train.optimizer.max_iter`
    on `first_batch`, then the batches of `loader`, one a step, evaluating
    `eval_dataset` (when given) every `train.eval_period` steps before the
    last, and tracing the steps `PROFILE_STEPS` into `profile_dir` (when
    given). Returns the last iteration."""
    max_iter = cfg.train.optimizer.max_iter
    log_period = max(int(cfg.train.log_period), 1)
    lr_sched = trainer.optimizer.schedule

    it = trainer.step_count
    t_start, it_start = time.time(), it
    metric_keys: List[str] = []
    pending = []  # (iteration, stacked metric vector on the device)
    host_rows = []  # (iteration, np.ndarray row): pulled, awaiting flush

    def drain(n_keep: int) -> None:
        while len(pending) > n_keep:
            i0, v0 = pending.pop(0)
            host_rows.append((i0, v0.cpu().numpy()))

    def flush() -> None:
        drain(0)
        if not host_rows:
            return
        now = time.time()
        for i_, row in host_rows:
            scalars = dict(zip(metric_keys, row.tolist()))
            scalars["lr"] = float(lr_sched(i_))
            if it > it_start:
                s_per_it = (now - t_start) / (it - it_start)
                scalars["eta_hours"] = s_per_it * (max_iter - i_) / 3600.0
            storage.put_scalars(i_, **scalars)
            for w in writers:
                w.write(storage)
        host_rows.clear()

    profiler = StepProfiler(profile_dir, trainer.device) if profile_dir else None
    batch = to_device(first_batch, trainer.device)
    while it < max_iter:
        if profiler is not None:
            profiler.at(it)
        metrics = trainer.step(batch)  # dispatched, not waited for
        if not metric_keys:
            metric_keys = list(metrics)
        pending.append((it + 1, torch.stack([metrics[k] for k in metric_keys])))
        # the next batch's upload overlaps the step on the device
        batch = to_device(next(loader), trainer.device)
        it += 1
        drain(ASYNC_DEPTH)
        do_ckpt = it % cfg.train.checkpoint_period == 0
        do_eval = bool(eval_dataset and cfg.train.eval_period
                       and it % cfg.train.eval_period == 0 and it < max_iter)
        if it % log_period == 0 or do_ckpt or do_eval or it >= max_iter:
            flush()
        if do_ckpt:
            ckpt.save(it, trainer)
        if do_eval:
            res = dispatch_eval(cfg, trainer.eval_model(), eval_dataset)
            storage.put_scalars(it, **{f"eval/{k}": float(v) for k, v in res.items()})
            for w in writers:
                w.write(storage, force=True)
    if profiler is not None:
        profiler.stop()
    flush()
    ckpt.save(it, trainer, force=True)
    return it


def synthetic_loader(batch: int, size: int, instances: int, seed: int,
                     num_classes: int = 80, start: int = 0) -> Iterable[dict]:
    """Seeded synthetic batches in the JAX bench's recipe
    (`trainer.synthetic_batch`), a new one a step: the global batch of
    `batch` images of step i is drawn from seed + i, so that a run resumed
    at step `start` reads what an uninterrupted one would, and this rank
    takes its rows of it (`parallel.local_rows`), so that the ranks
    together read what one process reads. On the host, as a data loader
    hands them."""
    i = start
    while True:
        yield {k: v.numpy() for k, v in local_rows(synthetic_batch(
            batch, size, instances, seed + i, num_classes, device="cpu")).items()}
        i += 1
