"""The gather probe's function: its plain PyTorch version and its two
hand-written CUDA kernels, K3 (`csrc/gather_rows.cu`, one warp per query) and
K4 (`csrc/gather_onehot_mma.cu`, one-hot products on the tensor cores).

    out[bm, q, :] = ((t_0 + t_1) + t_2) + ...,  t_k = table[bm, idx[bm, k, q], :]

table (BM, S, 128) f32 or bf16, idx (BM, K, QP) int32, out (BM, QP, 128) f32:
each gathered row is upcast to f32 and the K rows are added in k order, so
the kernels and the plain version agree bitwise. An index outside [0, S)
adds a zero row (what the one-hot product gives). This is one level's gather
of the deformable-attention kernel's 128-wide patch rows
(`tools/roofline_microbench.py`, the JAX package's probe); the port's probe
is `bm2f_tpu_torch.tools.roofline_microbench`.

The wrappers take contiguous CUDA tensors and raise on anything else: a CPU
caller uses `row_gather_sum_plain`. Each counts its launches, f32 tables in
`.launches` and bf16 tables in `.launches_bf16`.
"""

from __future__ import annotations

import ctypes

import torch

from bm2f_tpu_torch.ops import cuda_build

ROW = 128  # table row width: the 2x2 corners x D=32 of a patch row
ONEHOT_PASS = 64  # queries K4 takes per pass: qt is a multiple of it
ONEHOT_MAX_K = 4  # K4 keeps one accumulator per k in registers

_ROWS_SOURCE = "gather_rows.cu"
_ONEHOT_SOURCE = "gather_onehot_mma.cu"


def row_gather_sum_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The probe's function in plain PyTorch (the reference of K3 and K4):
    explicit f32 adds in k order, never `.sum(dim)`, whose order is not
    fixed."""
    BM, S, D = table.shape
    K, QP = idx.shape[1], idx.shape[2]
    flat = table.reshape(BM * S, D)
    base = torch.arange(BM, device=table.device).view(BM, 1) * S
    out = None
    for k in range(K):
        i = idx[:, k].long()
        valid = ((i >= 0) & (i < S)).unsqueeze(-1)
        rows = flat.index_select(0, (i.clamp(0, S - 1) + base).reshape(-1))
        rows = torch.where(valid, rows.view(BM, QP, D).float(), 0.0)
        out = rows if out is None else out + rows
    return torch.zeros(BM, QP, D, device=table.device) if out is None else out


def _check(table: torch.Tensor, idx: torch.Tensor):
    """(BM, S, K, QP, bf16). Raises unless table is a contiguous (BM, S, 128)
    f32 or bf16 CUDA tensor and idx a contiguous (BM, K, QP) int32 tensor on
    the same device."""
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 3 or table.shape[2] != ROW:
        raise ValueError(f"table must be (BM, S, {ROW}), got {tuple(table.shape)}")
    if idx.dim() != 3 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"idx must be (BM={table.shape[0]}, K, QP), got {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.shape[1] < 1:
        raise ValueError("table must have at least one row")
    if not table.is_cuda:
        raise ValueError(f"table must lie on a CUDA device, got {table.device}")
    if idx.device != table.device:
        raise ValueError(f"idx must lie on {table.device}, got {idx.device}")
    BM, S, _ = table.shape
    return BM, S, idx.shape[1], idx.shape[2], table.dtype == torch.bfloat16


def _entry(source: str, name: str, n_ints: int):
    """The C entry point `name` of `source`: table, idx and out pointers,
    n_ints ints, the stream."""
    fn = getattr(cuda_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return fn


def _launch(wrapper, source, name, table, idx, *extra):
    BM, S, K, QP, bf16 = _check(table, idx)
    out = torch.empty((BM, QP, ROW), device=table.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = _entry(source, f"{name}_{'bf16' if bf16 else 'f32'}", 4 + len(extra))
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), BM, S, K, QP, *extra,
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
    return out


def row_gather_sum_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K3 (one warp per (bm, q)). Raises as `_check` says, and when
    the build or the launch fails."""
    return _launch(row_gather_sum_cuda, _ROWS_SOURCE, "gather_rows", table, idx)


row_gather_sum_cuda.launches = 0
row_gather_sum_cuda.launches_bf16 = 0


def row_gather_sum_onehot_cuda(table: torch.Tensor, idx: torch.Tensor,
                               qt: int) -> torch.Tensor:
    """Launch K4 (one-hot products on the tensor cores, TF32 for an f32
    table: exact on values TF32 holds, as bf16-representable ones). `qt`, the
    queries of one block, is a multiple of 64; K is at most 4. Raises on
    anything else, as `_check` says, and when the build or the launch
    fails."""
    K = idx.shape[1] if idx.dim() == 3 else 0
    if not 1 <= K <= ONEHOT_MAX_K:
        raise ValueError(f"K4 takes 1 to {ONEHOT_MAX_K} indices per query, got {K}")
    if qt < ONEHOT_PASS or qt % ONEHOT_PASS:
        raise ValueError(f"qt={qt} must be a positive multiple of {ONEHOT_PASS}")
    return _launch(row_gather_sum_onehot_cuda, _ONEHOT_SOURCE, "gather_onehot",
                   table, idx, int(qt))


row_gather_sum_onehot_cuda.launches = 0
row_gather_sum_onehot_cuda.launches_bf16 = 0


def rows_read(idx: torch.Tensor, S: int) -> int:
    """The table rows this idx needs read: distinct in-range (bm, row)
    pairs."""
    i = idx.long()
    bm = torch.arange(idx.shape[0], device=idx.device).view(-1, 1, 1)
    valid = (i >= 0) & (i < S)
    return int(torch.unique((bm * S + i)[valid]).numel())


def gather_bytes(BM: int, K: int, QP: int, n_rows: int, table_itemsize: int) -> int:
    """Bytes the function must move: idx read once, the `n_rows` table rows
    it needs read once, the f32 output written once."""
    return 4 * BM * K * QP + n_rows * ROW * table_itemsize + 4 * BM * QP * ROW


def onehot_ops(BM: int, S: int, K: int, QP: int) -> int:
    """Operations of K4's dense one-hot products: K (QP, S) @ (S, 128)
    products per bm, a multiply and an add each."""
    return 2 * BM * QP * S * ROW * K
