"""The f32 compute scope of the entry points.

PyTorch's global `torch.backends.cudnn.allow_tf32` defaults to True, so an
f32 model on the card would run its convolutions in TF32 unless someone
turns it off. The JAX package's f32 configurations compute in f32, and so
do the port's entry points (`Predictor.predict`, `Trainer.step`): they run
f32 work inside `f32_scope`, whatever the global flags say, and restore
them after.
"""

from __future__ import annotations

import contextlib

import torch


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
