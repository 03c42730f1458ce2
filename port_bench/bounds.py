"""The yardstick's arithmetic: the card's published peaks, the least time
of a deformable-attention call from its shapes, and a forward's FLOPs
counted on the plain reference.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s HBM3.

The deformable core's bounds count each input read once and each output
written once, and one multiply-add per channel for each bilinear corner
that falls inside its level (the kernels skip the others), at the f32 rate
(the kernels accumulate in f32):
- forward: value (at its dtype's bytes), locations, weights and the f32
  output; 2 D FLOPs per valid corner;
- backward: value and d_value (at value's bytes), locations, weights and
  their gradients, and grad_out in f32; 4 D FLOPs per valid corner.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence, Tuple

import torch

from port_bench.reference.backbones import HERE as BACKBONES

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def valid_corners(shapes: Sequence[Tuple[int, int]], loc: torch.Tensor) -> int:
    """Bilinear corners inside their level over all samples: loc (B, Q, M,
    L, P, 2) in [0, 1], (x, y)."""
    n = torch.zeros((), dtype=torch.int64, device=loc.device)
    for lid, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5)
        y0 = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                n += ((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum()
    return int(n)


def least_seconds(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["float32"])


def deform_fwd_seconds(value_shape, value_bytes: int, shapes, loc: torch.Tensor) -> float:
    B, S, M, D = value_shape
    _, Q, _, L, P, _ = loc.shape
    n_bytes = value_bytes * B * S * M * D + 4 * (B * Q * M * L * P * 3 + B * Q * M * D)
    return least_seconds(n_bytes, 2 * D * valid_corners(shapes, loc))


def deform_bwd_seconds(value_shape, value_bytes: int, shapes, loc: torch.Tensor) -> float:
    B, S, M, D = value_shape
    _, Q, _, L, P, _ = loc.shape
    n_bytes = (value_bytes * 2 * B * S * M * D + 4 * 2 * B * Q * M * L * P * 3
               + 4 * B * Q * M * D)
    return least_seconds(n_bytes, 4 * D * valid_corners(shapes, loc))


def forward_flops(arch_dict: Mapping, batch: int, h: int, w: int,
                  backbones: Path = BACKBONES) -> float:
    """FLOPs of one forward of the reference at (batch, h, w), counted on
    the meta device: FlopCounterMode's products and convolutions, plus the
    deformable core's 2 x 4 corners x D per sample, which grid_sample hides
    from the counter. The backbone's file is looked up under `backbones`."""
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.model import Arch, forward, param_specs

    a = Arch.from_dict(arch_dict, backbones)
    P = {n: torch.empty(s, device="meta") for n, s, _ in param_specs(a)}
    with FlopCounterMode(display=False) as fc:
        forward(P, torch.empty(batch, h, w, 3, device="meta"), a)
    S = sum((h // s) * (w // s) for s in (8, 16, 32))
    core = 2 * 4 * batch * S * a.enc_heads * 3 * a.enc_points * (a.conv_dim // a.enc_heads)
    return float(fc.get_total_flops() + a.enc_layers * core)
