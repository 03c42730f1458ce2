"""Data loaders — replacement for detectron2's
build_detection_{train,test}_loader (reference: train_net.py:150-174,
mask2former_video/data_video/build.py:143,209).

TPU redesign: per-host sharded sampling (each process reads only its slice
of the global batch — the pjit input convention), background-thread
prefetch, and fixed-shape numpy batch collation.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from bm2f_tpu_torch.data.catalog import DatasetCatalog


class TrainingSampler:
    """Infinite shuffled index stream, sharded per host (reference:
    detectron2 TrainingSampler used by build.py:17)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            idx = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from idx[self.rank :: self.world_size].tolist()


class InferenceSampler:
    """One pass, contiguous per-host split."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard = (size + world_size - 1) // world_size
        self.indices = range(rank * shard, min((rank + 1) * shard, size))

    def __iter__(self):
        return iter(self.indices)


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # ragged metadata (e.g. orig sizes) stays a list
    return out


class _Prefetcher:
    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.it = it
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for x in self.it:
                self.q.put(x)
        finally:
            self.q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        x = self.q.get()
        if x is StopIteration:
            raise StopIteration
        return x


def build_train_loader(
    dataset_name: str,
    mapper: Callable[[dict], Optional[dict]],
    batch_size: int,
    *,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    prefetch: int = 2,
    filter_empty: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    dicts = DatasetCatalog.get(dataset_name)
    if filter_empty:
        dicts = [
            d for d in dicts
            if d.get("annotations") or d.get("segments_info")
            or d.get("sem_seg_file_name") or d.get("sem_seg") is not None
        ]
    sampler = TrainingSampler(len(dicts), seed=seed, rank=rank, world_size=world_size)

    def gen():
        buf = []
        for idx in sampler:
            sample = mapper(dicts[idx])
            if sample is None:
                continue
            buf.append(sample)
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []

    return _Prefetcher(gen(), depth=prefetch)


def build_test_loader(
    dataset_name: str,
    mapper: Callable[[dict], dict],
    batch_size: int = 1,
    *,
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[Dict]:
    dicts = DatasetCatalog.get(dataset_name)
    sampler = InferenceSampler(len(dicts), rank=rank, world_size=world_size)

    def gen():
        buf = []
        for idx in sampler:
            buf.append(mapper(dicts[idx]))
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []
        if buf:
            yield collate(buf)

    return gen()
