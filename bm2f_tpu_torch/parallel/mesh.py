"""Data parallelism across processes: the counterpart of the JAX package's
`parallel/mesh.py` (bm2f_tpu/parallel/mesh.py:20-57), in PyTorch's idiom.

The JAX package runs ONE SPMD step over a device mesh: the global batch is
sharded over the "data" axis, the parameters are replicated, and XLA sums
the gradient across devices. The port runs one process per card, started
by `python -m torch.distributed.run`, in one process group:

- `init_distributed` starts the group from the launcher's environment;
- each rank holds `local_rows` of the global batch (JAX's `shard_batch`:
  rank r takes the r-th contiguous block of rows);
- every batch-wide sum that the JAX step takes over the global batch (the
  criteria's denominators, the reported losses) goes through `global_sum`;
- `train.trainer.Trainer` wraps its model in `DistributedDataParallel` with
  a hook that sums the gradients across ranks.

Without a group every function here is the one-process identity (rank 0 of
1), so one-process results are bitwise what they were.
"""

from __future__ import annotations

import os
from typing import Mapping, TypeVar

import torch
import torch.distributed as dist

# what `torch.distributed.run` sets in every process it starts
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

T = TypeVar("T")


def init_distributed(device="cuda") -> torch.device:
    """Starts the default process group from the `torch.distributed.run`
    environment and returns this rank's device: for "cuda", the card
    LOCAL_RANK, made the current device, in an NCCL group; for "cpu", a
    gloo group. Raises, naming what is missing, when a variable is unset or
    NCCL cannot start; it never falls back to gloo or to one process."""
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs {', '.join(missing)} in the environment: launch "
            "with `python -m torch.distributed.run --nproc-per-node N -m "
            "bm2f_tpu_torch.train --distributed ...`")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    dev = torch.device(device)
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: no CUDA device is visible")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                               "CUDA devices are visible")
        if not dist.is_nccl_available():
            raise RuntimeError("--distributed on cuda: this PyTorch has no NCCL")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # device_id makes NCCL build its communicator now, so that a failure
        # raises here and not at the first collective
        dist.init_process_group("nccl", device_id=dev)
        dist.barrier()
    elif dev.type == "cpu":
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"--distributed on {device!r}: cuda (NCCL) or cpu (gloo)")
    return dev


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if _group() else 0


def world_size() -> int:
    """The number of ranks; 1 without a group."""
    return dist.get_world_size() if _group() else 1


def local_rows(batch: T, axis: int = 0) -> T:
    """This rank's rows of a global batch along `axis`: the r-th of
    `world_size()` equal contiguous blocks, as JAX's `shard_batch` places
    them. `batch` is a tensor, an array or a mapping of them (the same
    number of rows in each). Raises when the ranks do not divide the rows."""
    if isinstance(batch, Mapping):
        return {k: local_rows(v, axis) for k, v in batch.items()}
    n, w = batch.shape[axis], world_size()
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not divide over {w} ranks")
    k = n // w
    index = [slice(None)] * batch.ndim
    index[axis] = slice(rank() * k, (rank() + 1) * k)
    return batch[tuple(index)]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks (an all-reduce SUM of a copy); `t` itself
    without a group."""
    if not _group():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def barrier() -> None:
    """Waits for every rank; nothing without a group."""
    if _group():
        dist.barrier()


def check_mesh(cfg) -> None:
    """The port is data-parallel only: a `mesh.model` axis (the JAX
    package's tensor parallelism, bm2f_tpu/parallel/tp.py) raises."""
    if cfg.mesh.model > 1:
        raise NotImplementedError(
            f"mesh.model={cfg.mesh.model}: tensor parallelism is ROADMAP queue 1 "
            "item 20; the port trains data-parallel only (mesh.model=1)")
