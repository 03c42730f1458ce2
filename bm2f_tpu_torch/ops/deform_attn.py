"""Multi-scale deformable attention: the plain PyTorch version and the
dispatch to the hand-written CUDA kernel (`csrc/ms_deform_attn_fwd.cu`).

Semantics: for every (batch, query, head), sample each of L feature levels at
P locations with bilinear interpolation (zero padding outside, as
`grid_sample(2*loc-1, align_corners=False)`), and sum the samples weighted by
the softmaxed attention weights.

Shapes:
  value:              (B, S, M, D)   S = sum of H*W over levels
  spatial_shapes:     static tuple ((H0, W0), ..., (H_{L-1}, W_{L-1}))
  sampling_locations: (B, Q, M, L, P, 2)  normalized [0,1], (x, y)
  attention_weights:  (B, Q, M, L, P)
  returns:            (B, Q, M*D)
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from bm2f_tpu_torch.ops import cuda_build

_SOURCE = "ms_deform_attn_fwd.cu"
_MAX_LEVELS = 16
_MAX_D = 128


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                         attention_weights) -> torch.Tensor:
    """Row-gather formulation: value viewed as (B*M*S, D) rows, every
    (level, point, corner) sample one row index, bilinear and attention
    weights folded into one einsum. Corners outside the level get weight 0
    (their index is clamped into range and read, then multiplied by 0)."""
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    starts = level_start_index(spatial_shapes)
    dtype = value.dtype
    vflat = value.permute(0, 2, 1, 3).reshape(B * M * S, D)

    idx_all, w_all = [], []
    for lid, (H, W) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid]  # (B, Q, M, P, 2)
        attn = attention_weights[:, :, :, lid]  # (B, Q, M, P)
        fx = loc[..., 0] * W - 0.5
        fy = loc[..., 1] * H - 0.5
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        lx = (fx - x0).to(dtype)
        ly = (fy - y0).to(dtype)
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        for (yi, xi), w in (
            ((y0i, x0i), (1 - lx) * (1 - ly)),
            ((y0i, x0i + 1), lx * (1 - ly)),
            ((y0i + 1, x0i), (1 - lx) * ly),
            ((y0i + 1, x0i + 1), lx * ly),
        ):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yc = yi.clamp(0, H - 1)
            xc = xi.clamp(0, W - 1)
            idx_all.append(starts[lid] + yc * W + xc)  # (B, Q, M, P)
            w_all.append(w * valid.to(dtype) * attn)

    K = L * P * 4
    idx = torch.stack(idx_all, -1).permute(0, 2, 1, 3, 4).reshape(B, M, Q, K)
    w = torch.stack(w_all, -1).permute(0, 2, 1, 3, 4).reshape(B, M, Q, K)
    bm = torch.arange(B * M, device=value.device).reshape(B, M, 1, 1) * S
    rows = vflat.index_select(0, (idx + bm).reshape(-1)).reshape(B, M, Q, K, D)
    out = torch.einsum("bmqk,bmqkd->bqmd", w, rows)
    return out.reshape(B, Q, M * D)


def ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                        attention_weights) -> torch.Tensor:
    """Launch the hand-written kernel. Takes contiguous f32 CUDA tensors;
    raises on anything else, and when the build or the launch fails."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    L, P = len(spatial_shapes), sampling_locations.shape[4]
    for name, t, shape in (
        ("value", value, (B, S, M, D)),
        ("sampling_locations", sampling_locations, (B, Q, M, L, P, 2)),
        ("attention_weights", attention_weights, (B, Q, M, L, P)),
    ):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} must lie on {value.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D % 32 or D > _MAX_D:
        raise ValueError(f"head dim D={D} must be a multiple of 32 and <= {_MAX_D}")
    if L > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} levels, got {L}")

    out = torch.empty((B, Q, M * D), device=value.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _library()
    shapes = (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes for v in hw])
    stream = torch.cuda.current_stream(value.device).cuda_stream
    rc = lib.ms_deform_attn_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), shapes,
        B, S, M, D, Q, L, P, stream,
    )
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: CUDA error {rc}")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.ms_deform_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights) -> torch.Tensor:
    """Multi-scale deformable attention core (see module docstring). A CPU
    tensor takes the plain version; a CUDA tensor takes the kernel."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    total = sum(h * w for h, w in spatial_shapes)
    if total != value.shape[1]:
        raise ValueError(
            f"spatial_shapes {spatial_shapes} sum to {total} but value has "
            f"S={value.shape[1]}"
        )
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                               attention_weights)
