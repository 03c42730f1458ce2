"""Sine position embeddings (DETR-style), matching the reference
`PositionEmbeddingSine` (reference: position_encoding.py:12-52) with
normalize=True over an all-valid mask (the model never masks padded pixels).

The table depends only on the level's size, so it is computed once in f64
numpy per size and cached."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _interleave_sin_cos(pos: np.ndarray) -> np.ndarray:
    """torch: stack((p[..., 0::2].sin(), p[..., 1::2].cos()), -1).flatten(-2)."""
    s = np.sin(pos[..., 0::2])
    c = np.cos(pos[..., 1::2])
    return np.stack((s, c), axis=-1).reshape(*pos.shape[:-1], -1)


@functools.lru_cache(maxsize=64)
def _table(h: int, w: int, num_pos_feats: int, temperature: float,
           normalize: bool) -> np.ndarray:
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float64)
    x = np.arange(1, w + 1, dtype=np.float64)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_y = _interleave_sin_cos(y[:, None] / dim_t)  # (H, F)
    pos_x = _interleave_sin_cos(x[:, None] / dim_t)  # (W, F)
    pos = np.concatenate([
        np.broadcast_to(pos_y[:, None], (h, w, num_pos_feats)),
        np.broadcast_to(pos_x[None, :], (h, w, num_pos_feats)),
    ], axis=-1).astype(np.float32)
    pos.setflags(write=False)
    return pos


def sine_position_embedding_2d(
    h: int,
    w: int,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    *,
    device="cpu",
    dtype=torch.float32,
) -> torch.Tensor:
    """Returns (H, W, 2*num_pos_feats) with channel order [y-feats, x-feats]."""
    pos = _table(int(h), int(w), int(num_pos_feats), float(temperature),
                 bool(normalize))
    return torch.tensor(pos, device=device, dtype=dtype)
