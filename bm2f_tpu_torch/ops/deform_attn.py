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

`value` may be bf16 (bf16 serving and training): the forward then reads
bf16 rows and computes in f32 on the f32 locations and attention weights,
into an f32 output, as the JAX package's Pallas path does. The backward
reads the same bf16 rows, computes in f32, sums d_value in f32 and rounds it
to bf16 once; d_loc and d_attn stay f32.

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
    where a corner outside the level contributes to none of the sums.
    A bf16 `value` is upcast to f32 first and d_value rounded back to bf16
    at the end, as K2 on a bf16 `value` does."""
    if value.dtype == torch.bfloat16:
        d_value, d_loc, d_attn = ms_deform_attn_bwd_plain(
            value.float(), spatial_shapes, sampling_locations, attention_weights, grad_out)
        return d_value.to(torch.bfloat16), d_loc, d_attn
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


# the plain mirror's sort: digits of RADIX_BITS bits a pass (any stable
# sort gives the same order; K2's kernels take theirs from the library)
RADIX_BITS = 8


def pad_starts(spatial_shapes) -> Tuple[int, ...]:
    """The first key of each level in K2's padded grid of top-left corners:
    level l holds (H_l + 1)(W_l + 1) of them, (-1, -1) to (H_l - 1, W_l - 1)."""
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + (int(h) + 1) * (int(w) + 1))
    return tuple(starts)


def padded_size(spatial_shapes) -> int:
    """S_pad: the keys of one (b, m) in K2's padded grid."""
    return sum((int(h) + 1) * (int(w) + 1) for h, w in spatial_shapes)


class DestinationPlan(NamedTuple):
    """What K2's sample pass and sort leave for its reduce, for samples n =
    ((b M + m) Q + q) K + k:
      keys[n]  the padded top-left corner of sample n on its level,
               pad_starts[l] + (y0 + 1)(W + 1) + (x0 + 1); S_pad when no
               corner is inside the level;
      wa[n, c] w_c a, the bilinear weight of corner c times the attention
               weight; 0 for a corner outside the level;
      order    the sample indices sorted stably by (b M + m, key): ascending
               n within a key;
      row_ptr  the samples of key j of (b, m) are order[row_ptr[i] :
               row_ptr[i + 1]], i = (b M + m)(S_pad + 1) + j."""

    keys: torch.Tensor
    wa: torch.Tensor
    order: torch.Tensor
    row_ptr: torch.Tensor
    S_pad: int


def _sample_keys(spatial_shapes, loc, attn):
    """keys (-1 where no corner is inside) and wa (see DestinationPlan) of
    the samples of loc (..., L, P, 2) and attn (..., L, P), with K1's and
    K2's arithmetic: (..., L, P) and (..., L, P, 4)."""
    starts = pad_starts(spatial_shapes)
    keys, was = [], []
    for lid, (H, W) in enumerate(spatial_shapes):
        a = attn[..., lid, :]
        fx = loc[..., lid, :, 0] * W - 0.5
        fy = loc[..., lid, :, 1] * H - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        lx, ly = fx - x0, fy - y0
        wa = []
        for (yi, xi), w, _, _ in _corners(y0, x0, lx, ly):
            inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            wa.append(torch.where(inside, w * a, torch.zeros_like(w)))
        # any corner inside <=> the top-left corner in [-1, H-1] x [-1, W-1]
        # (compared in float, so NaN and huge locations never reach an int)
        any_in = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
        xi = x0.clamp(-1, W).to(torch.int64)
        yi = y0.clamp(-1, H).to(torch.int64)
        key = starts[lid] + (yi + 1) * (W + 1) + xi + 1
        keys.append(torch.where(any_in, key, torch.full_like(key, -1)))
        was.append(torch.stack(wa, -1))
    return torch.stack(keys, -2), torch.stack(was, -3)


def radix_order_plain(keys: torch.Tensor, max_key: int) -> torch.Tensor:
    """K2's sort with plain ops: the indices of `keys` (int, in [0, max_key])
    sorted stably, by LSD passes over RADIX_BITS-bit digits, each a stable
    counting sort (a digit's items keep their order)."""
    order = torch.arange(keys.numel(), device=keys.device)
    for shift in range(0, max(max_key.bit_length(), 1), RADIX_BITS):
        digit = (keys[order] >> shift) & ((1 << RADIX_BITS) - 1)
        order = torch.cat([order[digit == d] for d in range(1 << RADIX_BITS)])
    return order


def destination_plan(spatial_shapes, sampling_locations, attention_weights,
                     tiles: TilePlan = None) -> DestinationPlan:
    """K2's plan with plain ops: the sample pass, tile by tile as K2's blocks
    take them (`tiles`, by default the wrapper's `tile_plan(..., cells=True)`),
    each sample written at its own index, then the sort and the counts."""
    B, Q, M, L, P, _ = sampling_locations.shape
    K, dev, S_pad = L * P, sampling_locations.device, padded_size(spatial_shapes)
    if tiles is None:
        tiles = tile_plan(spatial_shapes, Q, cells=True)
    keys = torch.empty((B, M, Q, K), dtype=torch.int64, device=dev)
    wa = torch.empty((B, M, Q, K, 4), dtype=torch.float32, device=dev)
    for t in range(len(tiles.tile_ptr) - 1):
        qs = torch.from_numpy(tiles.tile_q[tiles.tile_ptr[t]:tiles.tile_ptr[t + 1]]).long()
        qs = qs.to(dev)
        k, w = _sample_keys(spatial_shapes, sampling_locations[:, qs],
                            attention_weights[:, qs])  # (B, nq, M, L, P[, 4])
        keys[:, :, qs] = k.reshape(B, len(qs), M, K).transpose(1, 2)
        wa[:, :, qs] = w.reshape(B, len(qs), M, K, 4).transpose(1, 2)
    keys = torch.where(keys < 0, S_pad, keys).reshape(-1)
    bm = torch.arange(keys.numel(), device=dev) // (Q * K)
    by_bm = bm * (S_pad + 1) + keys
    n_keys = B * M * (S_pad + 1)
    row_ptr = torch.nn.functional.pad(
        torch.cumsum(torch.bincount(by_bm, minlength=n_keys), 0), (1, 0))
    return DestinationPlan(keys, wa.reshape(-1, 4), radix_order_plain(by_bm, n_keys - 1),
                           row_ptr, S_pad)


def destination_entries(plan: DestinationPlan, spatial_shapes, B: int, M: int):
    """Every destination row r = (b S + s) M + m with its entries in K2's
    order: corner c = 0..3, then the samples of key (y - dy, x - dx) in
    ascending n. Returns (rows, samples, corners, positions) of all entries,
    position j being the entry's place in its row's sum, and the number of
    entries of each row."""
    S = sum(h * w for h, w in spatial_shapes)
    dev = plan.row_ptr.device
    r = torch.arange(B * S * M, device=dev)
    m, s, b = r % M, (r // M) % S, r // (M * S)
    starts = torch.tensor(level_start_index(spatial_shapes), device=dev)
    l = torch.bucketize(s, starts, right=True) - 1
    Ws = torch.tensor([w for _, w in spatial_shapes], device=dev)[l]
    y, x = (s - starts[l]) // Ws, (s - starts[l]) % Ws
    base = (b * M + m) * (plan.S_pad + 1) + torch.tensor(
        pad_starts(spatial_shapes), device=dev)[l]
    rows, samples, corners, positions = [], [], [], []
    done = torch.zeros_like(r)  # entries of earlier corners
    for c in range(4):
        key = base + (y - (c >> 1) + 1) * (Ws + 1) + x - (c & 1) + 1
        lo, cnt = plan.row_ptr[key], plan.row_ptr[key + 1] - plan.row_ptr[key]
        row = torch.repeat_interleave(r, cnt)
        j = torch.arange(int(cnt.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        rows.append(row)
        samples.append(plan.order[lo[row] + j])
        corners.append(torch.full_like(row, c))
        positions.append(done[row] + j)
        done = done + cnt
    return (torch.cat(rows), torch.cat(samples), torch.cat(corners),
            torch.cat(positions)), done


def d_value_by_destination(plan: DestinationPlan, spatial_shapes, grad_out, M: int,
                           dtype=torch.float32) -> torch.Tensor:
    """K2's d_value with plain ops, summed as its reduce sums: each row in
    the order of `destination_entries`, in f32, adding (w_c a) * grad_out
    row by row (a multiply and an add, each rounded), then cast to `dtype`
    once. grad_out: (B, Q, M*D). Returns (B, S, M, D)."""
    B, Q, MD = grad_out.shape
    D, S = MD // M, sum(h * w for h, w in spatial_shapes)
    K = plan.keys.numel() // (B * M * Q)
    (rows, samples, corners, positions), _ = destination_entries(plan, spatial_shapes, B, M)
    bm, q = samples // (Q * K), (samples // K) % Q
    g_rows = ((bm // M) * Q + q) * M + bm % M
    g = grad_out.reshape(-1, D).float()
    acc = torch.zeros((B * S * M, D), dtype=torch.float32, device=grad_out.device)
    for j in range(int(positions.max()) + 1 if positions.numel() else 0):
        at = positions == j
        acc[rows[at]] = acc[rows[at]] + plan.wa[samples[at], corners[at]][:, None] * g[
            g_rows[at]]
    return acc.reshape(B, S, M, D).to(dtype)


@functools.lru_cache(maxsize=64)
def _device_plan(spatial_shapes, Q: int, cells: bool, device):
    """`tile_plan` with its tables on `device`, built once per shape:
    (tile_ptr, tile_q, n_tiles), in a memory pool of their own
    (`utils.memory.kept_allocations`)."""
    from bm2f_tpu_torch.utils.memory import kept_allocations

    plan = tile_plan(spatial_shapes, Q, cells)
    with kept_allocations(device):
        tables = tuple(torch.from_numpy(a).to(device) for a in plan)
    return (*tables, len(plan.tile_ptr) - 1)


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
    _check(fn(value.data_ptr(), sampling_locations.data_ptr(),
              attention_weights.data_ptr(), out.data_ptr(), tile_ptr.data_ptr(),
              tile_q.data_ptr(), _shapes_arg(spatial_shapes), B, S, M, D, Q, L, P, n_tiles,
              _stream(value)), "ms_deform_attn_fwd")
    if bf16:
        ms_deform_attn_cuda.launches_bf16 += 1
    else:
        ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0
ms_deform_attn_cuda.launches_bf16 = 0


def ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """Launch K2: (d_value, d_loc, d_attn) from contiguous CUDA tensors,
    `value` f32 or bf16 and the rest f32, grad_out (B, Q, M*D). d_value comes
    in `value`'s dtype (a bf16 one summed in f32 and rounded once), d_loc and
    d_attn in f32. Every output is the same bits on every run: d_value is
    summed destination-major in a fixed order (`_bwd_sample`, a radix sort
    of the samples by key, `_bwd_reduce`; `destination_plan` and
    `d_value_by_destination` are the plain mirror). Raises as
    `ms_deform_attn_cuda` does. f32 launches count in `.launches`, bf16
    launches in `.launches_bf16`."""
    dims = _cuda_dims(value, spatial_shapes, sampling_locations, attention_weights,
                      grad_out, value_dtypes=(torch.float32, torch.bfloat16))
    B, S, M, D, Q, L, P = dims
    d_value = torch.empty(value.shape, device=value.device, dtype=value.dtype)
    if B * Q * M * L * P == 0:
        return (d_value.zero_(), torch.empty_like(sampling_locations),
                torch.empty_like(attention_weights))
    d_loc, d_attn, wa, keys = _bwd_sample(
        value, spatial_shapes, sampling_locations, attention_weights, grad_out, dims)
    S_pad = padded_size(spatial_shapes)
    order, sorted_keys = _radix_order_cuda(keys, Q * L * P, B * M, S_pad)
    row_ptr = _key_bounds(sorted_keys, Q * L * P, B * M, S_pad)
    _bwd_reduce(row_ptr, order, wa, grad_out, d_value, spatial_shapes, dims)
    if value.dtype == torch.bfloat16:
        ms_deform_attn_bwd_cuda.launches_bf16 += 1
    else:
        ms_deform_attn_bwd_cuda.launches += 1
    return d_value, d_loc, d_attn


ms_deform_attn_bwd_cuda.launches = 0
ms_deform_attn_bwd_cuda.launches_bf16 = 0


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_sample(value, spatial_shapes, loc, attn, grad_out, dims):
    """K2's step 1: (d_loc, d_attn, wa, keys); wa (n, 4) and keys (n,) by
    sample n = ((b M + m) Q + q) K + k."""
    B, S, M, D, Q, L, P = dims
    dev, n, S_pad = value.device, B * M * Q * L * P, padded_size(spatial_shapes)
    if n >= 2 ** 31 or B * M * (S_pad + 1) >= 2 ** 31:
        raise ValueError(f"{n} samples or {B * M} x {S_pad + 1} keys do not fit int32")
    d_loc, d_attn = torch.empty_like(loc), torch.empty_like(attn)
    wa = torch.empty((n, 4), device=dev, dtype=torch.float32)
    keys = torch.empty(n, device=dev, dtype=torch.int32)
    tile_ptr, tile_q, n_tiles = _device_plan(_shapes_key(spatial_shapes), Q, True, dev)
    name = "ms_deform_attn_bwd_sample" + ("_bf16" if value.dtype == torch.bfloat16 else "")
    _check(_kernel(_BWD_SOURCE, name, n_tensors=8)(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
        d_loc.data_ptr(), d_attn.data_ptr(), wa.data_ptr(), keys.data_ptr(),
        tile_ptr.data_ptr(), tile_q.data_ptr(), _shapes_arg(spatial_shapes), *dims,
        n_tiles, _stream(value)), name)
    return d_loc, d_attn, wa, keys


def _key_bounds(sorted_keys, seg_len: int, n_seg: int, S_pad: int):
    """row_ptr (n_seg (S_pad + 1) + 1,) int32: where each key's samples
    begin in the sorted order, segment by segment, with the total last."""
    row_ptr = torch.empty(n_seg * (S_pad + 1) + 1, device=sorted_keys.device,
                          dtype=torch.int32)
    fn = _c_function(_BWD_SOURCE, "msda_key_bounds",
                     [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    _check(fn(sorted_keys.data_ptr(), seg_len, n_seg, S_pad, row_ptr.data_ptr(),
              _stream(sorted_keys)), "msda_key_bounds")
    return row_ptr


def _radix_order_cuda(keys, seg_len: int, n_seg: int, max_key: int):
    """(order, sorted keys): the indices of `keys` (int32, n_seg segments of
    seg_len, each in [0, max_key]) sorted stably within each segment, and
    the keys in that order. LSD passes over the library's digits, each a
    count kernel, the scan of the per-block counts and a scatter kernel."""
    tile = _c_function(_BWD_SOURCE, "msda_sort_tile", [])()
    bits = _c_function(_BWD_SOURCE, "msda_radix_bits", [])()
    count = _c_function(_BWD_SOURCE, "msda_radix_count",
                        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    scatter = _c_function(_BWD_SOURCE, "msda_radix_scatter",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    stream = _stream(keys)
    hist = torch.empty(n_seg * (1 << bits) * -(-seg_len // tile), device=keys.device,
                       dtype=torch.int32)
    bufs = [(torch.empty_like(keys), torch.empty_like(keys)) for _ in range(2)]
    k_in, v_in = keys, None
    for p, shift in enumerate(range(0, max(max_key.bit_length(), 1), bits)):
        _check(count(k_in.data_ptr(), seg_len, n_seg, shift, hist.data_ptr(), stream),
               "msda_radix_count")
        scan = torch.cumsum(hist, 0, dtype=torch.int32)
        k_out, v_out = bufs[p % 2]
        _check(scatter(k_in.data_ptr(), None if v_in is None else v_in.data_ptr(),
                       k_out.data_ptr(), v_out.data_ptr(), seg_len, n_seg, shift,
                       hist.data_ptr(), scan.data_ptr(), stream), "msda_radix_scatter")
        k_in, v_in = k_out, v_out
    return v_in, k_in


def _bwd_reduce(row_ptr, order, wa, grad_out, d_value, spatial_shapes, dims) -> None:
    """K2's step 3: every row of d_value (f32 or bf16) written once."""
    B, S, M, D, Q, L, P = dims
    name = "ms_deform_attn_bwd_reduce" + ("_bf16" if d_value.dtype == torch.bfloat16 else "")
    fn = _c_function(_BWD_SOURCE, name, [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)]
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _check(fn(row_ptr.data_ptr(), order.data_ptr(), wa.data_ptr(), grad_out.data_ptr(),
              d_value.data_ptr(), _shapes_arg(spatial_shapes), *dims, _stream(d_value)), name)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _c_function(source: str, name: str, argtypes):
    """The C entry point `name` of `source`, returning an int (a CUDA
    error code, 0 for none)."""
    fn = getattr(cuda_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _kernel(source: str, name: str, n_tensors: int):
    """The C entry point `name` of `source`: n_tensors device pointers, the
    two tile tables on the device, the host (H, W) table, B, S, M, D, Q, L,
    P, n_tiles and the stream."""
    return _c_function(source, name, [ctypes.c_void_p] * (n_tensors + 2)
                       + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])


class MSDeformAttnFunction(torch.autograd.Function):
    """`ms_deform_attn` with its backward: K1 and K2 on CUDA tensors, the
    plain forward and `ms_deform_attn_bwd_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
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
