"""Multi-scale deformable attention: the plain PyTorch versions of the
forward and its backward, the hand-written CUDA kernels (K1
`csrc/ms_deform_attn_fwd.cu`, K2 `csrc/ms_deform_attn_bwd.cu`) and the
autograd Function that joins them.

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

`ms_deform_attn` always goes through `MSDeformAttnFunction`: CPU tensors take
the plain forward and the closed-form plain backward, CUDA tensors take K1
and K2. `ms_deform_attn_plain` on its own is differentiated by autograd and
serves as the independent reference on the card.

`value` may be bf16 (the bf16 serving path): the forward then reads bf16
rows and computes in f32 on the f32 locations and attention weights, into an
f32 output, as the JAX package's Pallas path does. Its gradient (K2 on a
bf16 `value`) is not ported yet, so the Function refuses a bf16 `value` when
any input requires grad.

The kernels work in tiles of neighbouring queries of one head (`tile_plan`,
built once per shape).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from bm2f_tpu_torch.ops import cuda_build

_FWD_SOURCE = "ms_deform_attn_fwd.cu"
_BWD_SOURCE = "ms_deform_attn_bwd.cu"
_MAX_LEVELS = 16
_MAX_D = 128

# The kernels' tiles (ms_deform_attn_common.cuh): runs of RUN consecutive
# queries, or for K2 when Q == S (the encoder: the queries are the levels'
# pixels, in order) encoder cells, every query whose reference point falls in
# one CELL x CELL cell of the finest level, on every level. On the H100 the
# cells made K2 3 % faster than runs and K1 no faster at the serve shapes
# (PERF.md).
CELL = 8
RUN = 64


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def _bilinear(loc, H: int, W: int, dtype):
    """Per-sample terms shared by the plain forward and backward: the
    top-left corner (y0, x0) as int64 and the fractional position (lx, ly)
    of locations (..., 2) in a level of H x W pixels."""
    fx = loc[..., 0] * W - 0.5
    fy = loc[..., 1] * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    return (y0.to(torch.int64), x0.to(torch.int64),
            (fx - x0).to(dtype), (fy - y0).to(dtype))


def _corners(y0, x0, lx, ly):
    """The four corners as ((y, x), w, dw/dlx, dw/dly), top-left first."""
    hx, hy = 1 - lx, 1 - ly
    return (
        ((y0, x0), hx * hy, -hy, -hx),
        ((y0, x0 + 1), lx * hy, hy, -lx),
        ((y0 + 1, x0), hx * ly, -ly, hx),
        ((y0 + 1, x0 + 1), lx * ly, ly, lx),
    )


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                         attention_weights) -> torch.Tensor:
    """Row-gather formulation: value viewed as (B*M*S, D) rows, every
    (level, point, corner) sample one row index, bilinear and attention
    weights folded into one einsum. Corners outside the level get weight 0
    (their index is clamped into range and read, then multiplied by 0). A
    bf16 `value` is upcast to f32 first, so the result is f32, as K1's."""
    if value.dtype == torch.bfloat16:
        value = value.float()
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    starts = level_start_index(spatial_shapes)
    dtype = value.dtype
    vflat = value.permute(0, 2, 1, 3).reshape(B * M * S, D)

    idx_all, w_all = [], []
    for lid, (H, W) in enumerate(spatial_shapes):
        attn = attention_weights[:, :, :, lid]  # (B, Q, M, P)
        y0, x0, lx, ly = _bilinear(sampling_locations[:, :, :, lid], H, W, dtype)
        for (yi, xi), w, _, _ in _corners(y0, x0, lx, ly):
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


def ms_deform_attn_bwd_plain(value, spatial_shapes, sampling_locations,
                             attention_weights, grad_out):
    """Closed-form backward of `ms_deform_attn_plain` (the math K2 follows).
    grad_out: (B, Q, M*D). Returns (d_value, d_loc, d_attn) in the inputs'
    shapes. For a sample with attention a and bilinear corner weights w_c:
      d_value[s_c] += a w_c g              (index_add_ over all samples)
      d_attn        = sum_c w_c dot_c      (dot_c = <value[s_c], g>)
      d_loc         = a (W sum_c dw_c/dlx dot_c, H sum_c dw_c/dly dot_c)
    where a corner outside the level contributes to none of the sums."""
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    starts = level_start_index(spatial_shapes)
    dtype = value.dtype
    vflat = value.permute(0, 2, 1, 3).reshape(B * M * S, D)
    g = grad_out.reshape(B, Q, M, 1, D)
    bm = (torch.arange(B, device=value.device).reshape(B, 1, 1, 1) * M
          + torch.arange(M, device=value.device).reshape(1, 1, M, 1)) * S
    d_vflat = torch.zeros_like(vflat)
    d_loc = torch.empty_like(sampling_locations)
    d_attn = torch.empty_like(attention_weights)
    for lid, (H, W) in enumerate(spatial_shapes):
        a = attention_weights[:, :, :, lid]  # (B, Q, M, P)
        y0, x0, lx, ly = _bilinear(sampling_locations[:, :, :, lid], H, W, dtype)
        sa = sx = sy = 0
        for (yi, xi), w, dwx, dwy in _corners(y0, x0, lx, ly):
            valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(dtype)
            rows = bm + starts[lid] + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            dot = (vflat[rows] * g).sum(-1) * valid  # (B, Q, M, P)
            sa = sa + w * dot
            sx = sx + dwx * dot
            sy = sy + dwy * dot
            d_vflat.index_add_(0, rows.reshape(-1),
                               ((w * valid * a)[..., None] * g).reshape(-1, D))
        d_attn[:, :, :, lid] = sa
        d_loc[:, :, :, lid, :, 0] = a * W * sx
        d_loc[:, :, :, lid, :, 1] = a * H * sy
    d_value = d_vflat.reshape(B, M, S, D).permute(0, 2, 1, 3).contiguous()
    return d_value, d_loc, d_attn


class TilePlan(NamedTuple):
    """Tile t holds the queries tile_q[tile_ptr[t]:tile_ptr[t + 1]]; int32
    arrays, as the kernels take them."""

    tile_ptr: np.ndarray  # (n_tiles + 1,)
    tile_q: np.ndarray  # (Q,)


def encoder_cells(spatial_shapes) -> np.ndarray:
    """The cell of every pixel of every level, in order: the index, on the
    CELL x CELL grid of the finest height and width, of the cell that holds
    the pixel's centre (its encoder reference point)."""
    Hf = max(h for h, _ in spatial_shapes)
    Wf = max(w for _, w in spatial_shapes)
    n_cx = -(-Wf // CELL)
    cells = []
    for H, W in spatial_shapes:
        y, x = np.divmod(np.arange(H * W), W)
        # floor(((y + 0.5) / H) * Hf / CELL), in integers
        cells.append(((2 * y + 1) * Hf) // (2 * H * CELL) * n_cx
                     + ((2 * x + 1) * Wf) // (2 * W * CELL))
    return np.concatenate(cells)


def tile_plan(spatial_shapes, Q: int, cells: bool) -> TilePlan:
    """The tiles of one call: encoder cells when `cells` and Q == S, else
    runs."""
    S = sum(int(h) * int(w) for h, w in spatial_shapes)
    if cells and Q == S:
        cell_of = encoder_cells(spatial_shapes)
        tile_q = np.argsort(cell_of, kind="stable")
        tile_ptr = np.concatenate([[0], np.cumsum(np.unique(cell_of, return_counts=True)[1])])
    else:
        tile_q = np.arange(Q)
        tile_ptr = np.append(np.arange(0, Q, RUN), Q)
    return TilePlan(tile_ptr.astype(np.int32), tile_q.astype(np.int32))


@functools.lru_cache(maxsize=64)
def _device_plan(spatial_shapes, Q: int, cells: bool, device):
    """`tile_plan` with its tables on `device`, built once per shape:
    (tile_ptr, tile_q, n_tiles)."""
    plan = tile_plan(spatial_shapes, Q, cells)
    return (*(torch.from_numpy(a).to(device) for a in plan), len(plan.tile_ptr) - 1)


def _cuda_dims(value, spatial_shapes, sampling_locations, attention_weights,
               grad_out=None, value_dtypes=(torch.float32,)) -> Tuple[int, ...]:
    """(B, S, M, D, Q, L, P). Raises unless every input is a contiguous
    tensor of its expected shape on value's CUDA device, `value` of one of
    `value_dtypes` and the others f32, and the sizes are ones the kernels
    take."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    L, P = len(spatial_shapes), sampling_locations.shape[4]
    specs = [
        ("value", value, (B, S, M, D)),
        ("sampling_locations", sampling_locations, (B, Q, M, L, P, 2)),
        ("attention_weights", attention_weights, (B, Q, M, L, P)),
    ]
    if grad_out is not None:
        specs.append(("grad_out", grad_out, (B, Q, M * D)))
    for name, t, shape in specs:
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} must lie on {value.device}, got {t.device}")
        want = value_dtypes if t is value else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(str(d)[6:] for d in want)}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D % 32 or D > _MAX_D:
        raise ValueError(f"head dim D={D} must be a multiple of 32 and <= {_MAX_D}")
    if L > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} levels, got {L}")
    return B, S, M, D, Q, L, P


def _shapes_key(spatial_shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _shapes_arg(spatial_shapes):
    L = len(spatial_shapes)
    return (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes for v in hw])


def ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                        attention_weights) -> torch.Tensor:
    """Launch K1: an f32 output from contiguous CUDA tensors, `value` f32 or
    bf16 and the rest f32. Raises on anything else, when the build or the
    launch fails, and when grad mode is on and an input requires grad: the
    output has no `grad_fn`, so a caller that wants gradients goes through
    `ms_deform_attn` (the autograd Function). f32 launches count in
    `.launches`, bf16 launches in `.launches_bf16`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        raise RuntimeError(
            "ms_deform_attn_cuda would cut the gradient here: call "
            "ms_deform_attn, whose autograd Function runs K1 and K2")
    B, S, M, D, Q, L, P = _cuda_dims(value, spatial_shapes, sampling_locations,
                                     attention_weights,
                                     value_dtypes=(torch.float32, torch.bfloat16))
    out = torch.empty((B, Q, M * D), device=value.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    bf16 = value.dtype == torch.bfloat16
    fn = _kernel(_FWD_SOURCE, "ms_deform_attn_fwd_bf16" if bf16 else "ms_deform_attn_fwd",
                 n_tensors=4)
    tile_ptr, tile_q, n_tiles = _device_plan(_shapes_key(spatial_shapes), Q, False,
                                             value.device)
    rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(), tile_ptr.data_ptr(),
            tile_q.data_ptr(), _shapes_arg(spatial_shapes), B, S, M, D, Q, L, P, n_tiles,
            torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn_fwd launch failed: CUDA error {rc}")
    if bf16:
        ms_deform_attn_cuda.launches_bf16 += 1
    else:
        ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0
ms_deform_attn_cuda.launches_bf16 = 0


def ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """Launch K2: (d_value, d_loc, d_attn) from contiguous f32 CUDA tensors,
    grad_out (B, Q, M*D). Raises as `ms_deform_attn_cuda` does. d_value is
    summed with atomics, so its last bits vary from run to run."""
    B, S, M, D, Q, L, P = _cuda_dims(value, spatial_shapes, sampling_locations,
                                     attention_weights, grad_out)
    d_value = torch.zeros_like(value)
    d_loc = torch.empty_like(sampling_locations)
    d_attn = torch.empty_like(attention_weights)
    if d_attn.numel() == 0:
        return d_value, d_loc, d_attn
    fn = _kernel(_BWD_SOURCE, "ms_deform_attn_bwd", n_tensors=7)
    tile_ptr, tile_q, n_tiles = _device_plan(_shapes_key(spatial_shapes), Q, True,
                                             value.device)
    rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad_out.data_ptr(), d_value.data_ptr(),
            d_loc.data_ptr(), d_attn.data_ptr(), tile_ptr.data_ptr(), tile_q.data_ptr(),
            _shapes_arg(spatial_shapes), B, S, M, D, Q, L, P, n_tiles,
            torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn_bwd launch failed: CUDA error {rc}")
    ms_deform_attn_bwd_cuda.launches += 1
    return d_value, d_loc, d_attn


ms_deform_attn_bwd_cuda.launches = 0


def _kernel(source: str, name: str, n_tensors: int):
    """The C entry point `name` of `source`: n_tensors device pointers, the
    two tile tables on the device, the host (H, W) table, B, S, M, D, Q, L,
    P, n_tiles and the stream."""
    fn = getattr(cuda_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (n_tensors + 2) + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn


class MSDeformAttnFunction(torch.autograd.Function):
    """`ms_deform_attn` with its backward: K1 and K2 on CUDA tensors, the
    plain forward and `ms_deform_attn_bwd_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        if value.dtype == torch.bfloat16 and any(ctx.needs_input_grad):
            raise NotImplementedError(
                f"gradients through ms_deform_attn on a {value.dtype} value: K2 "
                "takes f32 only (bf16 training is ROADMAP queue 1 item 10b)")
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        if value.device.type == "cpu":
            return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                        attention_weights)
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        bwd = (ms_deform_attn_bwd_plain if value.device.type == "cpu"
               else ms_deform_attn_bwd_cuda)
        d_value, d_loc, d_attn = bwd(value, ctx.spatial_shapes, loc, attn,
                                     grad_out.contiguous())
        need = ctx.needs_input_grad
        return (d_value if need[0] else None, None,
                d_loc if need[2] else None, d_attn if need[3] else None)


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights) -> torch.Tensor:
    """Multi-scale deformable attention core (see module docstring), with
    gradients. A CPU tensor takes the plain versions; a CUDA tensor takes
    the kernels."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    total = sum(h * w for h, w in spatial_shapes)
    if total != value.shape[1]:
        raise ValueError(
            f"spatial_shapes {spatial_shapes} sum to {total} but value has "
            f"S={value.shape[1]}"
        )
    return MSDeformAttnFunction.apply(value, spatial_shapes, sampling_locations,
                                      attention_weights)
