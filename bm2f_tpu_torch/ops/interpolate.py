"""Image resizing with the semantics the reference model depends on: PyTorch's
`F.interpolate` bilinear with `align_corners=False` and no antialiasing, and
legacy `nearest` (src = floor(dst * in / out)).

Layout: channels first, (..., H, W) — the last two axes are resized, any
leading axes are flattened into the batch. (The JAX package keeps (..., H, W,
C); the port is NCHW inside.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, out_h: int, out_w: int, mode: str) -> torch.Tensor:
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, *x.shape[-2:]) if x.dim() != 4 else x
    kw = {"align_corners": False, "antialias": False} if mode == "bilinear" else {}
    y = F.interpolate(x4, size=(out_h, out_w), mode=mode, **kw)
    return y.reshape(*lead, out_h, out_w)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes, torch half-pixel index math."""
    return _resize(x, out_h, out_w, "bilinear")


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Legacy nearest resize of the last two axes."""
    return _resize(x, out_h, out_w, "nearest")
