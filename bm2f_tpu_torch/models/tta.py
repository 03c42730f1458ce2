"""Test-time augmentation (reference: mask2former/test_time_augmentation.py:21
SemanticSegmentorWithTTA — multi-scale + horizontal-flip ensemble averaging
semantic probabilities; used for the zoo's "ms+flip" mIoU numbers), as the
JAX package's `bm2f_tpu/models/tta.py` computes it.

Layouts: the image and the averaged map are (H, W, C) as in the JAX
function; `ops.resize_bilinear` resizes the last two axes, so each is
moved to channels first around its resize.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from bm2f_tpu_torch.models.maskformer import semantic_inference
from bm2f_tpu_torch.ops import resize_bilinear


def _resize_hwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C), bilinear."""
    return resize_bilinear(x.movedim(-1, -3), h, w).movedim(-3, -1)


def tta_sizes(H: int, W: int, scales: Sequence[float]):
    """Each scale's input size: Python's round (half to even) of
    side * s / 32, times 32, as the JAX function computes it."""
    return [(int(round(H * s / 32)) * 32, int(round(W * s / 32)) * 32) for s in scales]


def semantic_tta(
    predict_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    image: torch.Tensor,  # (H, W, 3) raw
    scales: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
    flip: bool = True,
) -> torch.Tensor:
    """Returns the (H, W, K) semantic probabilities averaged over every
    scale and, with `flip`, its horizontal mirror.

    predict_fn: (1, h, w, 3) raw pixels -> (pred_logits (1, Q, K+1),
    pred_masks (1, Q, h4, w4)). A flipped prediction is flipped back on the
    semantic map's W axis before its resize to (H, W)."""
    H, W = image.shape[:2]
    image = image.float()
    acc = None
    count = 0
    for h, w in tta_sizes(H, W, scales):
        scaled = _resize_hwc(image[None], h, w)
        variants = [scaled]
        if flip:
            variants.append(scaled.flip(2))
        for vi, v in enumerate(variants):
            logits, masks = predict_fn(v)
            sem = semantic_inference(logits[0], masks[0])  # (h4, w4, K)
            if vi == 1:
                sem = sem.flip(1)
            sem = _resize_hwc(sem, H, W)
            acc = sem if acc is None else acc + sem
            count += 1
    return acc / count
