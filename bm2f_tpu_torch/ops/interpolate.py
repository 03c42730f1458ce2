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


def _dyn_index_weights(src: int, dst: int, out: int, device):
    """Source indices and weights for resizing a `src`-long prefix to a
    `dst`-long prefix of an `out`-long axis, in the JAX package's exact
    integer form (bm2f_tpu/ops/interpolate.py:72-93): the source position
    (i + 0.5) * src / dst - 0.5 is the int64 numerator (2i + 1) * src - dst
    over 2 * dst, the index its floor and the weight the remainder over
    2 * dst in f32. Entries at i >= dst clamp inside the source region."""
    i = torch.arange(out, dtype=torch.int64, device=device)
    num = ((2 * i + 1) * src - dst).clamp(min=0)
    den = 2 * dst
    i0 = torch.minimum(num // den, torch.tensor(src - 1, device=device))
    i1 = torch.minimum(i0 + 1, torch.tensor(src - 1, device=device))
    w1 = (num - i0 * den).to(torch.float32) / torch.tensor(float(den), device=device)
    return i0, i1, 1.0 - w1, w1


def resize_bilinear_dynamic(x: torch.Tensor, src_hw, dst_hw, out_h: int,
                            out_w: int) -> torch.Tensor:
    """Bilinear-resize the (src_h, src_w) top-left region of `x` (..., H, W)
    to the (dst_h, dst_w) top-left region of an (..., out_h, out_w) output,
    with torch's half-pixel index math in exact integers (the JAX package's
    `resize_bilinear_dynamic`, channels first). The eval crops its padding
    and restores each image's original size with it; pixels beyond the dst
    region hold edge-clamped values."""
    src_h, src_w = (int(s) for s in src_hw)
    dst_h, dst_w = (int(s) for s in dst_hw)
    i0, i1, w0, w1 = _dyn_index_weights(src_h, dst_h, out_h, x.device)
    w0, w1 = w0.to(x.dtype)[:, None], w1.to(x.dtype)[:, None]
    x = x.index_select(-2, i0) * w0 + x.index_select(-2, i1) * w1
    i0, i1, w0, w1 = _dyn_index_weights(src_w, dst_w, out_w, x.device)
    w0, w1 = w0.to(x.dtype), w1.to(x.dtype)
    return x.index_select(-1, i0) * w0 + x.index_select(-1, i1) * w1
