"""The gather probe on the card: the port of the JAX package's
`tools/roofline_microbench.py`.

    python -m bm2f_tpu_torch.tools.roofline_microbench [--iters 30] \\
        [--levels 625 2500] [--coherent] [--qt 512] [--kk 4] [--smoke] \\
        [--device cuda] [--parent-csrc DIR [DIR ...]]

It measures one level's gather of 128-wide rows (the deformable-attention
kernel's 2x2 patch rows, D=32) at production sizes: BM 32 (B=4 x M=8 heads),
QP 13312 queries (13125 padded), K 4 points per query, level tables of S rows
(10000 / 2500 / 625 at strides 8 / 16 / 32 of an 800x800 image). It compares
two formulations of `out[bm, q] = sum_k table[bm, idx[bm, k, q]]`
(`bm2f_tpu_torch/ops/gather_probe.py`):

  scalar, scalar_bf16  K3 (`csrc/gather_rows.cu`): a warp takes runs of 32
                       queries and reads their K rows, f32 or bf16 table;
  onehot, onehot_bf16  K4 (`csrc/gather_onehot_mma.cu`): K one-hot (QT, S) @
                       (S, 128) products on the tensor cores (TF32 or bf16),
                       only the fragments that hold a one, QT = --qt queries
                       per block (a multiple of 64).

`ROOFLINE_IMPLS=scalar,onehot` runs only the named impls. The data is the JAX
tool's: `RandomState(0)` tables rounded to bf16 (so the bf16 variants are
exactly comparable), then uniform-random indices, or with --coherent indices
near each query's own position in the level.

Each (impl, S) prints one JSON line under the JAX tool's keys (less
`unroll_q`), with `max_err_vs_plain` (against the plain version on the f32 table, at every S)
in place of `max_err_vs_xla`, and `bound_ms`, `bound_by`, `share_of_bound`,
`onehot_tc_bound_ms`, `onehot_hit_tc_bound_ms`, `staged_mb`, `plain_ms`
and `embedding_bag_ms`. Every impl
computes one function, K gathered rows added, which needs only bytes:
`bound_ms` is its bytes over the HBM rate for all four, and
`share_of_bound` is `bound_ms` over the impl's time. `onehot_tc_bound_ms`
(null for K3) is the dense one-hot products' operations over the tensor
cores' rate, the ceiling of that formulation only; `onehot_hit_tc_bound_ms`
counts only the products K4 issues, those whose one-hot fragment (16
queries x one MMA k-step) holds a one, and `staged_mb` the table bytes K4
stages from L2 (the chunks each 64-query pass selects). `embedding_bag_ms`
is one
`F.embedding_bag(mode="sum")` call on
the same rows, a yardstick the port never calls; on a bf16 table it returns
bf16). Times are CUDA-event means over --iters launches with a warm L2, on
the card the line names. A line whose kernel is not bitwise equal to the
plain version is printed and then raises. `--device cpu` runs the plain
version alone and measures nothing (times are null). The JAX tool's
`--unroll` (queries per TPU loop body) has no counterpart.

`--parent-csrc DIR [DIR ...]` builds each DIR's gather_rows.cu and
gather_onehot_mma.cu, those it holds (for example the parent commit's
`bm2f_tpu_torch/csrc`, unpacked with `git archive` into the git-ignored
`_archive/`, or a scratch copy of a design step there), whose entry points
take the same arguments. Each impl's line then gains `turns`: {DIR or
"shipped": [ms, ms]}, the designs timed in order (the DIRs as given, then
the shipped one) and then in reverse, each output checked bitwise against
the plain version. Needs a card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from bm2f_tpu_torch.ops import cuda_build
from bm2f_tpu_torch.ops.gather_probe import (
    ONEHOT_SOURCE,
    ROW,
    ROWS_SOURCE,
    call_entry,
    gather_bytes,
    onehot_hit_ops,
    onehot_ops,
    onehot_staged_rows,
    row_gather_sum_cuda,
    row_gather_sum_onehot_cuda,
    row_gather_sum_plain,
    rows_read,
)

BM = 32  # B=4 x M=8 heads
QP = 13312  # 13125 queries padded to 26 x 512
QT = 512
K = 4  # points per level
SMOKE = dict(BM=2, QP=128, QT=128, S=40)
IMPLS = ("scalar", "onehot", "onehot_bf16", "scalar_bf16")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate, tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TC_OPS_PER_S = {"onehot": 495e12, "onehot_bf16": 989e12}  # TF32, bf16

def make_inputs(S: int, coherent: bool, bm: int = None, qp: int = None,
                k: int = None):
    """(table (BM, S, 128) f32 rounded to bf16, idx (BM, K, QP) int32) as
    numpy arrays, drawn as the JAX tool draws them (`RandomState(0)`)."""
    bm, qp, k = bm or BM, qp or QP, k or K
    rng = np.random.RandomState(0)
    table = rng.randn(bm, S, ROW).astype(np.float32)
    table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    if coherent:
        # a query samples near its own position in the level (ring init,
        # small offsets): its row is its proportional position plus jitter
        base = np.linspace(0, S - 1, qp)[None, None, :]
        jitter = rng.randn(bm, k, qp) * max(2.0, S * 0.01)
        idx = np.clip(np.round(base + jitter), 0, S - 1).astype(np.int32)
    else:
        idx = rng.randint(0, S, (bm, k, qp)).astype(np.int32)
    return table, idx


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(impl: str, bm: int, k: int, qp: int, n_rows: int):
    """(least time in ms, what bounds it) of the function every impl
    computes, a sum of K gathered rows: its bytes over the HBM rate. It
    needs no multiply, so the one-hot impls share this bound."""
    itemsize = 2 if impl.endswith("bf16") else 4
    return gather_bytes(bm, k, qp, n_rows, itemsize) / PEAK_BYTES_PER_S * 1e3, "bytes"


def onehot_tc_bound_ms(impl: str, bm: int, S: int, k: int, qp: int):
    """The least time of the one-hot formulation's dense products on the
    tensor cores (its operations over their rate, TF32 or bf16), for the
    one-hot impls; None for the others. Work that the function does not
    need: a ceiling of the formulation, not of the function."""
    if not impl.startswith("onehot"):
        return None
    return onehot_ops(bm, S, k, qp) / PEAK_TC_OPS_PER_S[impl] * 1e3


def onehot_hit_tc_bound_ms(impl: str, idx: torch.Tensor, S: int):
    """The least time of the products K4 issues (those whose one-hot
    fragment holds a one) on the tensor cores, for the one-hot impls; None
    for the others."""
    if not impl.startswith("onehot"):
        return None
    return onehot_hit_ops(idx, S, impl.endswith("bf16")) / PEAK_TC_OPS_PER_S[impl] * 1e3


def designs(csrc_dirs):
    """{(directory, source): loaded library}: K3's and K4's sources in each
    directory, built in parallel."""
    specs = {(str(d), src): Path(d) / src for d in csrc_dirs
             for src in (ROWS_SOURCE, ONEHOT_SOURCE) if (Path(d) / src).is_file()}
    return cuda_build.build_variants(specs)


def bench_level(S: int, iters: int, coherent: bool = False, impls=None,
                device="cuda", qt: int = None, bm: int = None, qp: int = None,
                k: int = None, variants=None):
    """One JSON line per impl at level size S; returns the lines as dicts.
    `variants` ({(directory, source): library} from `designs`) adds each
    impl's builds of its own source, timed in turns beside the shipped one."""
    bm, qp, k, qt = bm or BM, qp or QP, k or K, qt or QT
    impls = impls or IMPLS
    dev = torch.device(device)
    table_np, idx_np = make_inputs(S, coherent, bm, qp, k)
    table = torch.from_numpy(table_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    tables = {"f32": table, "bf16": table.to(torch.bfloat16)}
    want = row_gather_sum_plain(table, idx)
    n_rows = rows_read(idx, S)
    flat_idx = (idx.long() + torch.arange(bm, device=dev).view(-1, 1, 1) * S)
    flat_idx = flat_idx.permute(0, 2, 1).reshape(bm * qp, k).contiguous()
    n_desc = bm * qp * k
    results = []
    for name in impls:
        t = tables["bf16" if name.endswith("bf16") else "f32"]
        if dev.type == "cpu":
            fn = lambda t=t: row_gather_sum_plain(t, idx)  # noqa: E731
        elif name.startswith("scalar"):
            fn = lambda t=t: row_gather_sum_cuda(t, idx)  # noqa: E731
        else:
            fn = lambda t=t: row_gather_sum_onehot_cuda(t, idx, qt)  # noqa: E731
        out = fn()
        line = {"impl": name, "S": S, "ms_per_level_layer": None,
                "ns_per_descriptor": None,
                "max_err_vs_plain": (out - want).abs().max().item(),
                "bitwise_equal": torch.equal(out, want),
                "addresses": "coherent" if coherent else "random",
                "qt": qt, "k": k, "bm": bm, "qp": qp, "device": str(dev)}
        line["bound_ms"], line["bound_by"] = bound(name, bm, k, qp, n_rows)
        line["onehot_tc_bound_ms"] = onehot_tc_bound_ms(name, bm, S, k, qp)
        line["onehot_hit_tc_bound_ms"] = onehot_hit_tc_bound_ms(name, idx, S)
        bf16 = name.endswith("bf16")
        line["staged_mb"] = (onehot_staged_rows(idx, S, bf16, qt) * ROW * (2 if bf16 else 4) / 1e6
                             if name.startswith("onehot") else None)
        line.update(share_of_bound=None, plain_ms=None, embedding_bag_ms=None)
        del out
        if dev.type == "cuda":
            line["device"] = torch.cuda.get_device_name(dev)
            ms = cuda_ms(fn, iters)
            flat_table = t.view(-1, ROW)
            line.update(
                ms_per_level_layer=ms, ns_per_descriptor=ms * 1e6 / n_desc,
                share_of_bound=line["bound_ms"] / ms,
                plain_ms=cuda_ms(lambda t=t: row_gather_sum_plain(t, idx), 3),
                embedding_bag_ms=cuda_ms(
                    lambda: F.embedding_bag(flat_idx, flat_table, mode="sum"), iters))
            if variants:
                line["turns"] = time_designs(name, fn, t, idx, qt, want, iters, variants)
        print(json.dumps(line), flush=True)
        if not line["bitwise_equal"]:
            raise AssertionError(f"{name} at S={S} differs from the plain version "
                                 f"(max abs err {line['max_err_vs_plain']})")
        results.append(line)
    return results


def time_designs(name, shipped, table, idx, qt, want, iters, variants):
    """{design: [ms, ms]}: the impl's builds of its own source in `variants`
    (labelled by directory), then the shipped wrapper, timed in order and
    then in reverse; raises if a design is not bitwise equal to the plain
    version."""
    onehot = name.startswith("onehot")
    src, entry = (ONEHOT_SOURCE, "gather_onehot") if onehot else (ROWS_SOURCE, "gather_rows")
    extra = (qt,) if onehot else ()
    calls = {d: (lambda lib=lib: call_entry(lib, entry, table, idx, *extra))
             for (d, source), lib in variants.items() if source == src}
    calls["shipped"] = shipped
    for label, fn in calls.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} design {label!r} differs from the plain version")
    order = list(calls)
    turns = {label: [] for label in order}
    for label in order + order[::-1]:
        turns[label].append(cuda_ms(calls[label], iters))
    return turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--levels", type=int, nargs="+", default=[625, 2500])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (BM 2, QP 128, QT 128, S 40), one launch each")
    ap.add_argument("--coherent", action="store_true",
                    help="production-like spatially coherent addresses "
                         "instead of uniform-random ones")
    ap.add_argument("--qt", type=int, default=None, help="query tile of K4")
    ap.add_argument("--kk", type=int, default=None, help="points per query")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain version only)")
    ap.add_argument("--parent-csrc", type=Path, nargs="+", default=None,
                    help="directories holding another build's gather_rows.cu or "
                         "gather_onehot_mma.cu, timed in turns with the shipped ones")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("roofline_microbench: no CUDA device (--device cpu runs the plain "
              "version)", file=sys.stderr)
        return 2
    only = os.environ.get("ROOFLINE_IMPLS")
    impls = [i for i in IMPLS if not only or i in only.split(",")]
    kw = dict(impls=impls, device=args.device, qt=args.qt, k=args.kk,
              coherent=args.coherent)
    if args.device != "cpu" and args.parent_csrc:
        kw["variants"] = designs(args.parent_csrc)
    if args.smoke:
        bench_level(SMOKE["S"], 1, bm=SMOKE["BM"], qp=SMOKE["QP"],
                    **{**kw, "qt": args.qt or SMOKE["QT"]})
        return 0
    for S in args.levels:
        bench_level(S, args.iters, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
