"""The gather probe's function: its plain PyTorch version and its two
hand-written CUDA kernels, K3 (`csrc/gather_rows.cu`, a row gather: a warp
takes runs of 32 queries) and K4 (`csrc/gather_onehot_mma.cu`, one-hot
products on the tensor cores, issued only where the selector holds a one).

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
ONEHOT_TILE = 16  # queries of one MMA fragment, a warp's row block in K4
ONEHOT_STEP = {False: 8, True: 16}  # MMA k, by bf16: TF32 m16n8k8, bf16 m16n8k16
ONEHOT_CHUNK_STEPS = 16  # MMA k-steps of one chunk K4 stages
# a block walks every chunk when its first pass sets this share of the bits
# c % ONEHOT_DENSE_BITS of the chunks c it selects, of min(chunks, bits)
ONEHOT_DENSE_SHARE, ONEHOT_DENSE_BITS = 15 / 16, 32

ROWS_SOURCE = "gather_rows.cu"
ONEHOT_SOURCE = "gather_onehot_mma.cu"


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


def call_entry(lib: ctypes.CDLL, name: str, table: torch.Tensor, idx: torch.Tensor,
               *extra: int) -> torch.Tensor:
    """One launch of the C entry point `name`_f32 or `name`_bf16 (by the
    table's dtype) of a loaded library: the shipped one, a design step's or
    a parent commit's, which share the entry points' names and arguments
    (table, idx and out pointers, BM, S, K, QP, the `extra` ints, the
    stream). Raises as `_check` says and when the launch fails; counts
    nothing."""
    BM, S, K, QP, bf16 = _check(table, idx)
    out = torch.empty((BM, QP, ROW), device=table.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = getattr(lib, f"{name}_{'bf16' if bf16 else 'f32'}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (4 + len(extra)) + [ctypes.c_void_p]
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), BM, S, K, QP, *extra,
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _launch(wrapper, source, name, table, idx, *extra):
    _check(table, idx)  # before any build: a CPU tensor raises here
    out = call_entry(cuda_build.load(source), name, table, idx, *extra)
    if out.numel() == 0:
        return out
    if table.dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
    return out


def row_gather_sum_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K3 (a warp takes a run of 32 queries of one bm). Raises as
    `_check` says, and when the build or the launch fails."""
    return _launch(row_gather_sum_cuda, ROWS_SOURCE, "gather_rows", table, idx)


row_gather_sum_cuda.launches = 0
row_gather_sum_cuda.launches_bf16 = 0


def row_gather_sum_onehot_cuda(table: torch.Tensor, idx: torch.Tensor,
                               qt: int) -> torch.Tensor:
    """Launch K4 (one-hot products on the tensor cores, TF32 for an f32
    table: exact on values TF32 holds, as bf16-representable ones; a product
    whose one-hot fragment is all zeros is skipped, and so is a chunk of the
    table that no query of a pass selects). `qt`, the
    queries of one block, is a multiple of 64; K is at most 4. Raises on
    anything else, as `_check` says, and when the build or the launch
    fails."""
    K = idx.shape[1] if idx.dim() == 3 else 0
    if not 1 <= K <= ONEHOT_MAX_K:
        raise ValueError(f"K4 takes 1 to {ONEHOT_MAX_K} indices per query, got {K}")
    if qt < ONEHOT_PASS or qt % ONEHOT_PASS:
        raise ValueError(f"qt={qt} must be a positive multiple of {ONEHOT_PASS}")
    return _launch(row_gather_sum_onehot_cuda, ONEHOT_SOURCE, "gather_onehot",
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


def _blocks(idx: torch.Tensor, S: int, rows: int, queries: int, per_k: bool) -> torch.Tensor:
    """The distinct (bm, k if per_k, q // queries, s // rows) blocks that the
    in-range indices s = idx[bm, k, q] fall in, each as one int64 key."""
    BM, K, QP = idx.shape
    i = idx.long()
    valid = (i >= 0) & (i < S)
    n_q, n_s = (QP + queries - 1) // queries, (S + rows - 1) // rows
    q = torch.arange(QP, device=idx.device).view(1, 1, QP) // queries
    lead = torch.arange(BM, device=idx.device).view(BM, 1, 1) * (K if per_k else 1)
    if per_k:
        lead = lead + torch.arange(K, device=idx.device).view(1, K, 1)
    return torch.unique(((lead * n_q + q) * n_s + i // rows)[valid])


def onehot_hit_steps(idx: torch.Tensor, S: int, bf16: bool) -> int:
    """The products K4 issues: (bm, k, 16-query tile, MMA k-step) whose
    one-hot A fragment holds a one. Each covers all 128 channels."""
    return int(_blocks(idx, S, ONEHOT_STEP[bf16], ONEHOT_TILE, True).numel())


def onehot_dense_steps(BM: int, S: int, K: int, QP: int, bf16: bool) -> int:
    """Every (bm, k, 16-query tile, MMA k-step) of the dense product."""
    step = ONEHOT_STEP[bf16]
    return BM * K * ((QP + ONEHOT_TILE - 1) // ONEHOT_TILE) * ((S + step - 1) // step)


def onehot_hit_ops(idx: torch.Tensor, S: int, bf16: bool) -> int:
    """Operations of the products K4 issues: 16 queries x k-step rows x 128
    channels, a multiply and an add each, per hit fragment."""
    return 2 * ONEHOT_TILE * ONEHOT_STEP[bf16] * ROW * onehot_hit_steps(idx, S, bf16)


def onehot_staged_rows(idx: torch.Tensor, S: int, bf16: bool, qt: int) -> int:
    """Table rows K4 stages from L2 into shared memory at block size `qt`.
    A pass stages the chunks its indices select, the last one cut at S; a
    block whose first pass selects chunks c that set at least
    ONEHOT_DENSE_SHARE of min(chunks, 32) bits c % 32 walks, and stages,
    every row in each of its passes."""
    rows = ONEHOT_STEP[bf16] * ONEHOT_CHUNK_STEPS
    QP = idx.shape[2]
    n_chunks, n_pass = (S + rows - 1) // rows, (QP + ONEHOT_PASS - 1) // ONEHOT_PASS
    keys = _blocks(idx, S, rows, ONEHOT_PASS, False)  # (bm, pass, chunk)
    chunk, bm_pass = keys % n_chunks, keys // n_chunks
    n = idx.shape[0] * n_pass
    # the bits c % 32 set and the rows selected by every (bm, pass)
    bits = torch.unique(bm_pass * ONEHOT_DENSE_BITS + chunk % ONEHOT_DENSE_BITS)
    seen = torch.bincount(bits // ONEHOT_DENSE_BITS, minlength=n).view(-1, n_pass)
    tail = n_chunks * rows - S
    sel_rows = (torch.bincount(bm_pass, minlength=n) * rows
                - torch.bincount(bm_pass[chunk == n_chunks - 1], minlength=n) * tail
                ).view(-1, n_pass)
    staged = 0
    per_block = qt // ONEHOT_PASS
    for p0 in range(0, n_pass, per_block):
        block = slice(p0, min(p0 + per_block, n_pass))
        dense = seen[:, p0] >= ONEHOT_DENSE_SHARE * min(n_chunks, ONEHOT_DENSE_BITS)
        walked = block.stop - p0
        staged += int(torch.where(dense, torch.full_like(dense, S * walked, dtype=torch.long),
                                  sel_rows[:, block].sum(1)).sum())
    return staged
