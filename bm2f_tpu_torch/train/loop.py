"""The training loop: the counterpart of the JAX package's `run_train_loop`
(root train.py:40-147), written, as it is, for asynchronous dispatch:

- no per-step device synchronise: the iteration counter is kept on the
  host (each `Trainer.step` adds exactly one);
- each step's metric scalars are stacked into ONE device vector at dispatch
  time, and the host pulls a vector only once it is `ASYNC_DEPTH` steps old
  (by then the device has long finished it); writers flush at `log_period`
  from the pulled rows;
- the next batch is uploaded while the current step runs on the device;
- a save every `train.checkpoint_period` steps and a forced save at the end.

The scalars carry `lr` and `eta_hours` as the JAX loop's do. Evaluation
during training (`dispatch_eval`) waits for the evaluators (ROADMAP queue 1
item 10): the loop refuses an eval dataset.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Mapping, Sequence

import torch

from bm2f_tpu_torch.train.trainer import synthetic_batch

# how many dispatched-but-unpulled steps may be in flight (train.py:37)
ASYNC_DEPTH = 4
# the batch keys the step reads
BATCH_KEYS = ("images", "labels", "masks", "valid")


def to_device(batch: Mapping[str, object], device: torch.device) -> dict:
    """The step's keys of a host batch (numpy arrays or CPU tensors) on
    `device`; from pinned memory and without blocking on the card, so that
    the copy overlaps the step in flight."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.as_tensor(batch[k])
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def run_train_loop(cfg, trainer, loader: Iterator[Mapping[str, object]],
                   first_batch: Mapping[str, object], ckpt, storage,
                   writers: Sequence, eval_dataset: str = "") -> int:
    """Steps `trainer` from its `step_count` to `cfg.train.optimizer.max_iter`
    on `first_batch`, then the batches of `loader`, one a step. Returns the
    last iteration."""
    if eval_dataset:
        raise NotImplementedError(
            f"evaluation during training ({eval_dataset!r}): the evaluators are "
            "ROADMAP queue 1 item 10")
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

    batch = to_device(first_batch, trainer.device)
    while it < max_iter:
        metrics = trainer.step(batch)  # dispatched, not waited for
        if not metric_keys:
            metric_keys = list(metrics)
        pending.append((it + 1, torch.stack([metrics[k] for k in metric_keys])))
        # the next batch's upload overlaps the step on the device
        batch = to_device(next(loader), trainer.device)
        it += 1
        drain(ASYNC_DEPTH)
        do_ckpt = it % cfg.train.checkpoint_period == 0
        if it % log_period == 0 or do_ckpt or it >= max_iter:
            flush()
        if do_ckpt:
            ckpt.save(it, trainer)
    flush()
    ckpt.save(it, trainer, force=True)
    return it


def synthetic_loader(batch: int, size: int, instances: int, seed: int,
                     num_classes: int = 80, start: int = 0) -> Iterable[dict]:
    """Seeded synthetic batches in the JAX bench's recipe
    (`trainer.synthetic_batch`), a new one a step: the batch of step i is
    drawn from seed + i, so that a run resumed at step `start` reads what an
    uninterrupted one would. On the host, as a data loader hands them."""
    i = start
    while True:
        yield {k: v.numpy() for k, v in synthetic_batch(
            batch, size, instances, seed + i, num_classes, device="cpu").items()}
        i += 1
