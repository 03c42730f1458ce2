"""Out-of-memory resilient execution on the card (reference:
mask2former_video/utils/memory.py:27-80 `retry_if_cuda_oom`; the JAX
package's `bm2f_tpu/utils/memory.py`).

`retry_if_oom(fn)` catches `torch.OutOfMemoryError` only, frees the
caching allocator's unused blocks and runs the call again on the two
halves of its batch, recursively, concatenating the halves' outputs. The
retry runs outside the `except` block, so that the traceback's frames no
longer hold the failed call's tensors when the halves allocate. At batch 1
it raises, naming the input's shape.

Two departures from the JAX function: its last rung moves the call to the
CPU, which hides the device (not ported; ROADMAP §3), and its docstring
promises a plain retry first, which its code does not make (neither does
this one). A video clip is one item, so for the video eval this frees the
cache and raises a clear error.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable

import numpy as np
import torch


def _take(a, axis: int, lo: int, hi: int):
    return a[(slice(None),) * axis + (slice(lo, hi),)]


def _concat(x, y, axis: int):
    """Two halves' outputs joined along the batch axis: tensors, numpy
    arrays, and tuples, lists or dicts of them."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, y], axis)
    if isinstance(x, np.ndarray):
        return np.concatenate([x, y], axis)
    if isinstance(x, dict):
        return {k: _concat(x[k], y[k], axis) for k in x}
    if isinstance(x, (tuple, list)):
        return type(x)(_concat(a, b, axis) for a, b in zip(x, y))
    raise TypeError(f"cannot join outputs of type {type(x).__name__} along a batch axis")


def retry_if_oom(fn: Callable, batch_axis: int = 0) -> Callable:
    """`fn(*args)` whose positional args (tensors or arrays) share the batch
    axis `batch_axis`; out of device memory, the batch is halved until it
    fits. Every split counts in `retry_if_oom.splits`."""

    @functools.wraps(fn)
    def wrapped(*args: Any):
        try:
            return fn(*args)
        except torch.OutOfMemoryError as e:
            message = str(e)  # keeps no frame of the failed call alive
        torch.cuda.empty_cache()
        n = args[0].shape[batch_axis]
        if n <= 1:
            raise torch.OutOfMemoryError(
                f"out of device memory at batch 1 (input shape {tuple(args[0].shape)}), "
                f"with nothing left to split: {message}")
        half = n // 2
        retry_if_oom.splits += 1
        first = wrapped(*(_take(a, batch_axis, 0, half) for a in args))
        second = wrapped(*(_take(a, batch_axis, half, n) for a in args))
        return _concat(first, second, batch_axis)

    return wrapped


retry_if_oom.splits = 0


_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


@contextlib.contextmanager
def kept_allocations(device):
    """Allocations inside go to a memory pool of their own on a CUDA
    `device` (nothing changes on the CPU). For tensors kept across calls,
    such as tables cached per shape: made in the middle of a forward from
    the caching allocator's free blocks, each would pin the segment it was
    carved from, which `torch.cuda.empty_cache` could then not release, nor
    `retry_if_oom` reuse for the halves of a batch."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    with _POOLS_LOCK:
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool, device):
        yield
