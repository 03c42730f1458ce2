"""Point sampling with torch `F.grid_sample` / point_rend `point_sample`
semantics (bilinear, align_corners=False, zero padding), written as the JAX
package writes it (bm2f_tpu/ops/sampling.py:18-71): a flat row gather of the
four corners, so that the two agree to f32 rounding. It backs the matcher's
point-sampled costs and the criterion's point-sampled mask losses.

Layout: NHWC, as the JAX package's. The JAX package's corner-packed table
(`build_corner_table` / `point_sample_packed`) gives bitwise the same values
and exists for a TPU's gather cost; the port does not need it.
"""

from __future__ import annotations

import torch


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); grid (B, N, 2) with (x, y) in [-1, 1]. Returns
    (B, N, C)."""
    B, H, W, C = img.shape
    x = (grid[..., 0] + 1.0) * (W * 0.5) - 0.5  # unnormalized source coords
    y = (grid[..., 1] + 1.0) * (H * 0.5) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    flat = img.reshape(B * H * W, C)
    b_offset = torch.arange(B, device=img.device)[:, None] * (H * W)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = b_offset + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[idx] * valid[..., None].to(img.dtype)

    w00 = ((1 - lx) * (1 - ly))[..., None].to(img.dtype)
    w01 = (lx * (1 - ly))[..., None].to(img.dtype)
    w10 = ((1 - lx) * ly)[..., None].to(img.dtype)
    w11 = (lx * ly)[..., None].to(img.dtype)
    return (gather(y0i, x0i) * w00 + gather(y0i, x0i + 1) * w01
            + gather(y0i + 1, x0i) * w10 + gather(y0i + 1, x0i + 1) * w11)


def point_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """point_rend-style sampling: img (B, H, W, C), coords (B, N, 2) (x, y)
    in [0, 1]. Returns (B, N, C)."""
    return grid_sample(img, coords * 2.0 - 1.0)
