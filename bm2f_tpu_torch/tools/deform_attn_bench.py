"""K1 and K2, design step by design step, timed in turns on the card.

    python -m bm2f_tpu_torch.tools.deform_attn_bench [--parent-csrc DIR]
        [--out output/deform_attn_bench.jsonl]

Times the wrapper calls (the head-major transposes included) of K1 on an
f32 and a bf16 `value` and of K2, on encoder-like inputs (`deform_inputs`),
at the serve shapes (800x800, B=1 and 4) and the train shapes (1024x1024,
B=2), for each step of the design:
  runs    tiles of RUN consecutive queries of one head (step 1: 16-byte
          rows, each sample worked out once by one lane of its group; K1
          as it ships);
  cells   encoder cells, every query whose reference point falls in one
          8x8 cell of the finest level (step 2; K2 as it ships).
With --parent-csrc, also the first design (one warp per (b, q, m), 4-byte
loads, scalar atomics), built from that directory's ms_deform_attn_*.cu and
headers, for example the parent commit's `bm2f_tpu_torch/csrc` unpacked with
`git archive` into the git-ignored `_archive/`; its entry points take
`value` token-major and no tile tables.

Each (kernel, shape) runs its designs in order and then in reverse order,
so every design has two CUDA-event means; every design's output is held
against the shipped design's. Prints one JSON line per (kernel, shape,
design) and writes them to --out. Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from bm2f_tpu_torch.ops import cuda_build, deform_attn
from bm2f_tpu_torch.ops.deform_attn import (
    TilePlan,
    ms_deform_attn_bwd_cuda,
    ms_deform_attn_cuda,
    tile_plan,
)

M, D, P = 8, 32, 4
SERVE_SHAPES = ((25, 25), (50, 50), (100, 100))  # 800x800, strides 32, 16, 8
TRAIN_SHAPES = ((32, 32), (64, 64), (128, 128))  # 1024x1024
ITERS = {"fwd": 50, "fwd_bf16": 50, "bwd": 20}


def deform_inputs(B, shapes, Q, gen, dev, loc_range=None):
    """value, locations, attention weights from a seeded generator. With
    `loc_range` the locations are uniform in it; else they sit around the
    encoder's reference points, a few pixels off, as in the model."""
    from bm2f_tpu_torch.models.pixel_decoder import encoder_reference_points

    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(B, S, M, D, generator=gen).to(dev)
    if loc_range is not None:
        lo, hi = loc_range
        loc = torch.rand(B, Q, M, L, P, 2, generator=gen) * (hi - lo) + lo
    else:
        ref = encoder_reference_points(shapes)[:Q]  # (Q, L, 2)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        off = torch.randn(B, Q, M, L, P, 2, generator=gen) * 2.0
        loc = ref[None, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    attn = torch.softmax(torch.randn(B, Q, M, L * P, generator=gen), -1)
    return value, loc.contiguous().to(dev), attn.view(B, Q, M, L, P).to(dev)


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


def parent_kernels(csrc: Path):
    """The first design's entry points, built from `csrc` with the port's
    nvcc flags: {name: ctypes function}."""
    entries = {"ms_deform_attn_fwd.cu": ("ms_deform_attn_fwd", "ms_deform_attn_fwd_bf16"),
               "ms_deform_attn_bwd.cu": ("ms_deform_attn_bwd",)}
    libs = cuda_build.build_variants({src: csrc / src for src in entries})
    fns = {}
    for src, names in entries.items():
        dll = libs[src]
        for name in names:
            fn = getattr(dll, name)
            fn.restype = ctypes.c_int
            n_ptr = 7 if name.endswith("bwd") else 4
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.POINTER(ctypes.c_int)]
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            fns[name] = fn
    return fns


def parent_call(fns, kernel, shapes, v, loc, attn, g):
    """One call of the first design's `kernel`, allocating as its wrapper
    did (value token-major, no transposes)."""
    B, S, M_, D_ = v.shape
    Q, L, P_ = loc.shape[1], len(shapes), loc.shape[4]
    hw = (ctypes.c_int * (2 * L))(*[x for s in shapes for x in s])
    stream = torch.cuda.current_stream().cuda_stream
    dims = (B, S, M_, D_, Q, L, P_, stream)
    if kernel == "bwd":
        dv, dl, da = torch.zeros_like(v), torch.empty_like(loc), torch.empty_like(attn)
        rc = fns["ms_deform_attn_bwd"](v.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                                       g.data_ptr(), dv.data_ptr(), dl.data_ptr(),
                                       da.data_ptr(), hw, *dims)
        out = (dv, dl, da)
    else:
        out = torch.empty(B, Q, M_ * D_, device=v.device)
        name = "ms_deform_attn_fwd_bf16" if v.dtype == torch.bfloat16 else "ms_deform_attn_fwd"
        rc = fns[name](v.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), hw,
                       *dims)
    if rc != 0:
        raise RuntimeError(f"parent {kernel} launch failed: CUDA error {rc}")
    return out


def device_tables(plan: TilePlan, dev):
    """`plan` as the wrappers' `_device_plan` gives it, on `dev`."""
    return (*(torch.from_numpy(a).to(dev) for a in plan), len(plan.tile_ptr) - 1)


def new_call(kernel, tables, shapes, v, loc, attn, g):
    """One wrapper call of the redesigned `kernel` with `tables` from
    `device_tables` in place of its own."""
    def run():
        if kernel == "bwd":
            return ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        with torch.no_grad():
            return ms_deform_attn_cuda(v, shapes, loc, attn)
    with mock.patch.object(deform_attn, "_device_plan", lambda *a: tables):
        return run()


def max_err(a, b) -> float:
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def bench(kernel, shapes, B, parent, gen, dev):
    S = sum(h * w for h, w in shapes)
    v, loc, attn = deform_inputs(B, shapes, S, gen, dev)
    if kernel == "fwd_bf16":
        v = v.to(torch.bfloat16)
    g = torch.randn(B, S, M * D, generator=gen).to(dev) if kernel == "bwd" else None
    designs = {name: device_tables(tile_plan(shapes, S, cells), dev)
               for name, cells in (("runs", False), ("cells", True))}
    calls = {name: (lambda t=t: new_call(kernel, t, shapes, v, loc, attn, g))
             for name, t in designs.items()}
    if parent is not None:
        calls = {"parent": lambda: parent_call(parent, kernel, shapes, v, loc, attn, g),
                 **calls}
    shipped = calls["cells"]()
    errs = {name: max_err(fn(), shipped) for name, fn in calls.items()}
    order = list(calls)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(cuda_ms(calls[name], ITERS[kernel]))
    return [{"kernel": kernel, "shapes": "serve" if shapes == SERVE_SHAPES else "train",
             "B": B, "design": name, "ms": [round(t, 4) for t in times[name]],
             "max_abs_vs_cells": errs[name]} for name in order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=Path, default=None)
    ap.add_argument("--out", default="output/deform_attn_bench.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("deform_attn_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    parent = parent_kernels(args.parent_csrc) if args.parent_csrc else None
    gen = torch.Generator().manual_seed(0)
    lines = []
    for kernel, shapes, B in (("fwd", SERVE_SHAPES, 1), ("fwd", SERVE_SHAPES, 4),
                              ("fwd", TRAIN_SHAPES, 2), ("fwd_bf16", SERVE_SHAPES, 1),
                              ("fwd_bf16", SERVE_SHAPES, 4), ("bwd", TRAIN_SHAPES, 2)):
        for line in bench(kernel, shapes, B, parent, gen, dev):
            print(json.dumps(line), flush=True)
            lines.append(line)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
