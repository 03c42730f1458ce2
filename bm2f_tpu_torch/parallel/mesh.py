"""Data and tensor parallelism across processes: the counterpart of the JAX
package's `parallel/mesh.py` (bm2f_tpu/parallel/mesh.py:20-57), in
PyTorch's idiom.

The JAX package runs ONE SPMD step over a (data, model) device mesh: the
global batch is sharded over the "data" axis, the wide transformer
parameters over the "model" axis (bm2f_tpu/parallel/tp.py), and XLA sums
the gradient across devices. The port runs one process per card, started
by `python -m torch.distributed.run`, in one process group:

- `init_distributed` starts the group from the launcher's environment;
- `init_mesh(model)` lays the ranks out as JAX's `create_mesh` lays out the
  devices, row-major over (data, model): global rank r has data rank
  r // model and model rank r % model. A rank's model group is the `model`
  consecutive ranks of its data rank, its data group the ranks of its
  model rank (`Mesh`);
- each rank holds `local_rows` of the global batch (JAX's `shard_batch`:
  data rank d takes the d-th contiguous block of rows; the ranks of a model
  group hold the same rows);
- every batch-wide sum that the JAX step takes over the global batch (the
  criteria's denominators, the reported losses) goes through `global_sum`,
  over the data group;
- `train.trainer.Trainer` wraps its model in `DistributedDataParallel`
  over the data group with a hook that sums the gradients, and shards it
  over the model group (`parallel.tp`).

Without a group every function here is the one-process identity (rank 0 of
1), and with `model` 1 the data group is the default group, so those
results are bitwise what they were before the model axis existed.
"""

from __future__ import annotations

import os
from typing import Mapping, NamedTuple, Optional, TypeVar

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


class Mesh(NamedTuple):
    """This rank's place in the (data, model) grid, and its two groups:
    `data_group` None is the default group (a mesh of `model` 1),
    `model_group` None a model axis of 1."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None


# the grid `init_mesh` built, with the default group it was built over
_built: dict = {}


def init_mesh(model: int = 1, data: int = -1) -> Mesh:
    """Lays the default group's ranks out as a (data, model) grid (`data`
    -1: world // model, as JAX's `create_mesh`) and builds its groups,
    once per default group: every rank calls it, in the same order (each
    group is made by all ranks). Raises, naming both numbers, when `model`
    does not divide the world or, with `model` > 1, `data` x `model` is not
    the world (at `model` 1 every rank is a data replica, whatever `data`
    says, as before the model axis existed)."""
    w = world_size()
    if model < 1 or w % model:
        raise ValueError(f"mesh.model={model} does not divide the world of {w} ranks")
    if model == 1:  # every rank a data replica, as before the model axis
        _built.clear()
        return Mesh(rank(), w, 0, 1)
    data = w // model if data == -1 else data
    if data * model != w:
        raise ValueError(f"mesh.data={data} x mesh.model={model} is not the world of "
                         f"{w} ranks")
    world = dist.group.WORLD
    got = _built.get("mesh")
    if got is not None and _built.get("world") is world:
        if got.model_size != model:
            raise ValueError(f"mesh.model={model}, but this group's mesh has "
                             f"model={got.model_size}")
        return got
    r = rank()
    mine = {}
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if d == r // model:
            mine["model"] = g
    for m in range(model):
        g = dist.new_group(list(range(m, w, model)))
        if m == r % model:
            mine["data"] = g
    _built.update(world=world, mesh=Mesh(r // model, data, r % model, model,
                                         mine["data"], mine["model"]))
    return _built["mesh"]


def current_mesh() -> Mesh:
    """The grid `init_mesh` built for the current default group; without
    one, every rank on the data axis (model 1)."""
    if _group() and _built.get("world") is dist.group.WORLD:
        return _built["mesh"]
    return Mesh(rank(), world_size(), 0, 1)


def data_rank() -> int:
    return current_mesh().data_rank


def data_size() -> int:
    """The number of data-parallel replicas: world // model."""
    return current_mesh().data_size


def model_rank() -> int:
    return current_mesh().model_rank


def model_size() -> int:
    return current_mesh().model_size


def local_rows(batch: T, axis: int = 0) -> T:
    """This rank's rows of a global batch along `axis`: the d-th of
    `data_size()` equal contiguous blocks for data rank d, as JAX's
    `shard_batch` places them over the "data" axis. `batch` is a tensor, an
    array or a mapping of them (the same number of rows in each). Raises
    when the data replicas do not divide the rows."""
    if isinstance(batch, Mapping):
        return {k: local_rows(v, axis) for k, v in batch.items()}
    n, (d, w) = batch.shape[axis], current_mesh()[:2]
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not divide over {w} "
                         "data-parallel ranks")
    k = n // w
    index = [slice(None)] * batch.ndim
    index[axis] = slice(d * k, (d + 1) * k)
    return batch[tuple(index)]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data group (an all-reduce SUM of a copy): over
    every rank at `model` 1, and counted once per model group otherwise,
    whose ranks hold the same rows; `t` itself without a group."""
    if not _group():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=current_mesh().data_group)
    return t


def barrier() -> None:
    """Waits for every rank; nothing without a group."""
    if _group():
        dist.barrier()
