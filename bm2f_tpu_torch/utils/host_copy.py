"""Copies across the host link through page-locked host memory from
PyTorch's caching host allocator.

A copy from or into fresh pageable memory runs at a few GB/s and blocks
the host; from or into pinned memory it runs at the link's speed and can
be enqueued without blocking. The allocator keeps freed pinned blocks for
reuse, and does not hand a block out again until the copies enqueued on
it have run, so neither function below needs to wait for its own copies.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """`array` as a tensor of its dtype and shape on `device`. On the card
    it is staged in C order in a pinned block and copied without blocking
    the host; on the CPU it is a copy, so the caller may change `array`
    afterwards."""
    cuda = torch.device(device).type == "cuda"
    dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
    host = torch.empty(array.shape, dtype=dtype, pin_memory=cuda)
    host.numpy()[...] = array
    return host.to(device, non_blocking=cuda)


def to_host(tensors: Dict, device) -> Tuple[Dict, Optional[torch.cuda.Event]]:
    """Enqueues the copy of each tensor of `tensors` (a dict, nested dicts
    allowed) into a pinned host tensor behind the launches that compute it,
    and records an event after the last copy; returns the host tensors in
    the same layout and the event. The host tensors hold their values once
    the event has completed, and keep their pinned blocks until they are
    dropped. A caller that waits on the event, not on the stream, lets work
    enqueued after the copies run meanwhile (the demo draws one image while
    the next one's forward runs). Off the card the tensors are returned as
    they are, with no event."""
    if torch.device(device).type != "cuda":
        return tensors, None

    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        return torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)

    host = copy(tensors)
    done = torch.cuda.Event()
    done.record()
    return host, done
