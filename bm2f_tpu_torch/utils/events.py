"""Metric logging — replacement for detectron2's EventStorage/EventWriter
stack (reference: train_net.py:281-285 build_writers, utils/wandb_writer.py:6-35
WandBWriter; loss keys are per-component and per-aux-layer, e.g. loss_ce_3).

Writers: console, JSONL file, TensorBoard (if available), wandb (if
available and enabled).

The port's copy of the JAX package's bm2f_tpu/utils/events.py (which is
JAX-free), so that both packages log the same lines; the port imports
nothing of the JAX package."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional


class EventStorage:
    def __init__(self, window: int = 20):
        self._hist = defaultdict(lambda: deque(maxlen=window))
        self._latest: Dict[str, float] = {}
        self.step = 0

    def put_scalars(self, step: int, **scalars: float):
        self.step = step
        for k, v in scalars.items():
            v = float(v)
            self._hist[k].append(v)
            self._latest[k] = v

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def smoothed(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._hist.items() if v}


class ConsoleWriter:
    def __init__(self, log_period: int = 20, max_keys: int = 8):
        self.log_period = log_period
        self.max_keys = max_keys
        self._t = time.time()

    def write(self, storage: EventStorage):
        if storage.step % self.log_period != 0:
            return
        s = storage.smoothed()
        dt = (time.time() - self._t) / max(self.log_period, 1)
        self._t = time.time()
        main = {
            k: v for k, v in s.items()
            if not any(ch.isdigit() for ch in k.rsplit("_", 1)[-1])
        }
        items = "  ".join(f"{k}: {v:.4f}" for k, v in list(main.items())[: self.max_keys])
        print(f"iter {storage.step}  {items}  ({dt*1000:.0f} ms/it)", flush=True)


class JSONWriter:
    def __init__(self, path: str, log_period: int = 20):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")
        self.log_period = log_period

    def write(self, storage: EventStorage):
        if storage.step % self.log_period != 0:
            return
        rec = {"iteration": storage.step, **storage.smoothed()}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()


class TensorBoardWriter:
    def __init__(self, log_dir: str, log_period: int = 20):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.w = SummaryWriter(log_dir)
        except Exception:
            self.w = None
        self.log_period = log_period

    def write(self, storage: EventStorage):
        if self.w is None or storage.step % self.log_period != 0:
            return
        for k, v in storage.latest().items():
            self.w.add_scalar(k, v, storage.step)


class WandBWriter:
    """Gated on wandb availability (reference utils/wandb_writer.py)."""

    def __init__(self, project: str = "bm2f_tpu", name: str = "",
                 entity: str = "", group: str = "", log_period: int = 20):
        try:
            import wandb

            self.run = wandb.init(
                project=project, name=name or None, entity=entity or None,
                group=group or None,
            )
            self.wandb = wandb
        except Exception:
            self.run = None
        self.log_period = log_period

    def write(self, storage: EventStorage):
        if self.run is None or storage.step % self.log_period != 0:
            return
        self.wandb.log(storage.latest(), step=storage.step)
