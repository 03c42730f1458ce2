"""The precision the plain reference computes in.

The reference computes in float32 with TF32 off (`Numerics("f32")`). Its
control is the same reference in the nearest precision below the one a
configuration states, over everything computed inside `Numerics.scope`:

- "fp8", below bfloat16: every floating tensor that an operation of the
  scope takes or makes, forward and backward, rounded to float8 e4m3's
  precision: 3 bits of mantissa, to nearest even, each value with its own
  power of two (the range a well-chosen scale gives; one scale a tensor
  flushes the pairwise loss's backward to 0 / 0). Weights, images,
  activations, the criterion's points and costs, and gradients are all
  rounded; each operation computes on the rounded values in float32, as
  the card's fp8 products accumulate. Infinities (the attention's blocked
  logits) pass unrounded. Views and in-place updates are left as they are
  (their values were rounded where they were made).
- "tf32", below float32: TF32 on for the products and convolutions, as a
  float32 model on the card computes with it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x at e4m3's precision: its mantissa in [0.5, 1) rounded as e4m3 holds
    it, its power of two kept."""
    mant, exp = torch.frexp(x)
    q = torch.ldexp(mant.to(torch.float8_e4m3fn).to(x.dtype), exp)
    return torch.where(torch.isfinite(x), q, x)


def _rounds(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() > 0


class FP8(TorchDispatchMode):
    """Rounds the floating inputs and outputs of every functional operation
    to `fp8` (the mode is off inside its own dispatch)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if func.is_view or schema.is_mutable or any(r.alias_info for r in schema.returns):
            return func(*args, **kwargs)
        rnd = lambda t: fp8(t) if _rounds(t) else t
        out = func(*tree_map(rnd, args), **tree_map(rnd, kwargs))
        return tree_map(rnd, out)


class Numerics:
    KINDS = ("f32", "tf32", "fp8")

    def __init__(self, kind: str = "f32"):
        if kind not in self.KINDS:
            raise ValueError(f"numerics {kind!r}: one of {self.KINDS}")
        self.kind = kind

    @contextlib.contextmanager
    def scope(self):
        """Computes the scope in this precision; TF32 off unless "tf32"."""
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = (cudnn.allow_tf32, matmul.allow_tf32)
        cudnn.allow_tf32 = matmul.allow_tf32 = self.kind == "tf32"
        try:
            with FP8() if self.kind == "fp8" else contextlib.nullcontext():
                yield
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved
