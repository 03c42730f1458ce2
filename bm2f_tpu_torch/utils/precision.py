"""The f32 compute scope and the deterministic scope of the entry points.

PyTorch's global `torch.backends.cudnn.allow_tf32` defaults to True, so an
f32 model on the card would run its convolutions in TF32 unless someone
turns it off. The JAX package's f32 configurations compute in f32, and so
do the port's entry points (`Predictor.predict`, `Trainer.step`): they run
f32 work inside `f32_scope`, whatever the global flags say, and restore
them after.

The JAX train step is deterministic on its chip; PyTorch's is not by
default (cuDNN picks nondeterministic convolution backward algorithms, and
the row gather of `ops/sampling.py` has an atomic backward). `Trainer.step`
therefore runs inside `deterministic_scope`, whatever the caller's global
settings, and restores them after. On the card's PyTorch (2.11, CUDA 12.8)
deterministic mode raises no alert on cuBLAS products without
`CUBLAS_WORKSPACE_CONFIG`, so the scope sets no environment variable. The
scope turns off the mode's filling of every new tensor
(`torch.utils.deterministic.fill_uninitialized_memory`): a detector of
reads of memory never written, not part of determinism, which cost 4.9k
launches and 30-50 ms of a full-size f32 step on an H100 (PERF.md §6); the
step writes every tensor before it reads it, and two steps from one seed
end bitwise equal with it off (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils.deterministic as det


@contextlib.contextmanager
def f32_scope(model_dtype: str):
    """For `model.dtype == "float32"`: TF32 off in cuDNN convolutions and in
    matrix products for the scope; the other cuDNN flags as they were. Any
    other dtype computes in it and leaves the flags alone."""
    if model_dtype != "float32":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_scope():
    """PyTorch's deterministic algorithms on (alerts raise) without the
    filling of new tensors, cuDNN deterministic and not benchmarking, for
    the scope; the caller's settings, warn-only and fill included, restored
    after."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            yield
    finally:
        det.fill_uninitialized_memory = saved[2]
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
