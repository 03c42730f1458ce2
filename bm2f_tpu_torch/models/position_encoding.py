"""Sine position embeddings (DETR-style), matching the reference
`PositionEmbeddingSine` (reference: position_encoding.py:12-52) with
normalize=True over an all-valid mask (the model never masks padded pixels),
and its video variant `PositionEmbeddingSine3D`
(mask2former_video/modeling/transformer_decoder/position_encoding.py:29-57),
as the JAX package computes them (bm2f_tpu/models/position_encoding.py).

A table that depends only on the level's size (and the clip's length) is
computed once in f64 numpy per size and cached. The frame-masked video
embedding depends on which frames are real, so its temporal term is computed
in f32 on the mask's device, as JAX computes it."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_SCALE = 2 * math.pi
_EPS = 1e-6


def _interleave_sin_cos(pos: np.ndarray) -> np.ndarray:
    """torch: stack((p[..., 0::2].sin(), p[..., 1::2].cos()), -1).flatten(-2)."""
    s = np.sin(pos[..., 0::2])
    c = np.cos(pos[..., 1::2])
    return np.stack((s, c), axis=-1).reshape(*pos.shape[:-1], -1)


def _dim_t(num_pos_feats: int, temperature: float) -> np.ndarray:
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    return temperature ** (2 * (dim_t // 2) / num_pos_feats)


def _axis(n: int, normalize: bool) -> np.ndarray:
    """Positions 1..n, normalized to (0, 2 pi]."""
    v = np.arange(1, n + 1, dtype=np.float64)
    return v / (n + _EPS) * _SCALE if normalize else v


def _yx_f64(h: int, w: int, num_pos_feats: int, temperature: float,
            normalize: bool) -> np.ndarray:
    """(H, W, 2F) in f64, channels [y-feats, x-feats]."""
    dim_t = _dim_t(num_pos_feats, temperature)
    pos_y = _interleave_sin_cos(_axis(h, normalize)[:, None] / dim_t)  # (H, F)
    pos_x = _interleave_sin_cos(_axis(w, normalize)[:, None] / dim_t)  # (W, F)
    return np.concatenate([
        np.broadcast_to(pos_y[:, None], (h, w, num_pos_feats)),
        np.broadcast_to(pos_x[None, :], (h, w, num_pos_feats)),
    ], axis=-1)


def _frozen_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    x.setflags(write=False)
    return x


@functools.lru_cache(maxsize=64)
def _table(h: int, w: int, num_pos_feats: int, temperature: float,
           normalize: bool) -> np.ndarray:
    return _frozen_f32(_yx_f64(h, w, num_pos_feats, temperature, normalize))


@functools.lru_cache(maxsize=64)
def _table_3d(t: int, h: int, w: int, num_pos_feats: int, temperature: float,
              normalize: bool) -> np.ndarray:
    # the temporal features use twice the channels' dim_t and are ADDED
    # across the full width
    pos_z = _interleave_sin_cos(_axis(t, normalize)[:, None]
                                / _dim_t(2 * num_pos_feats, temperature))  # (T, 2F)
    pos_yx = _yx_f64(h, w, num_pos_feats, temperature, normalize)
    return _frozen_f32(pos_yx[None] + pos_z[:, None, None])


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
    """Returns (H, W, 2*num_pos_feats) with channel order [y-feats, x-feats]
    (`layers.device_constant`: on the card, kept and not to be modified in
    place)."""
    from bm2f_tpu_torch.models.layers import device_constant

    args = (int(h), int(w), int(num_pos_feats), float(temperature), bool(normalize))
    return device_constant(("sine_2d",) + args, lambda: _table(*args), device, dtype)


def sine_position_embedding_3d(
    t: int,
    h: int,
    w: int,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    *,
    device="cpu",
    dtype=torch.float32,
) -> torch.Tensor:
    """Video variant: cat(pos_y, pos_x) + pos_z, where the temporal features
    use a 2*num_pos_feats dim_t and are added across the full channel width.
    Returns (T, H, W, 2*num_pos_feats)."""
    pos = _table_3d(int(t), int(h), int(w), int(num_pos_feats), float(temperature),
                    bool(normalize))
    return torch.tensor(pos, device=device, dtype=dtype)


def sine_position_embedding_3d_masked(
    frame_valid: torch.Tensor,
    h: int,
    w: int,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    *,
    dtype=torch.float32,
) -> torch.Tensor:
    """Frame-masked video embedding (reference PositionEmbeddingSine3D:
    z = not_mask.cumsum(1) / z[:, -1:]), so the temporal normalization sees
    only the real frames: padding a clip to a frame bucket leaves each valid
    frame's embedding equal to the true-length clip's up to f32 rounding.
    frame_valid: (B, T) bool; everything is built on its device, the
    temporal term in f32. Returns (B, T, H, W, 2*num_pos_feats)."""
    dev = frame_valid.device
    z = torch.cumsum(frame_valid.float(), dim=1)  # 1..T_true on valid frames
    z = z / (z[:, -1:] + _EPS) * _SCALE
    dim_t_z = torch.tensor(_dim_t(2 * num_pos_feats, temperature), dtype=torch.float32,
                           device=dev)
    arg = z[..., None] / dim_t_z  # (B, T, 2F)
    pos_z = torch.stack([torch.sin(arg[..., 0::2]), torch.cos(arg[..., 1::2])],
                        dim=-1).flatten(-2)
    pos_yx = sine_position_embedding_2d(h, w, num_pos_feats, temperature, device=dev)
    return (pos_yx[None, None] + pos_z[:, :, None, None]).to(dtype)
