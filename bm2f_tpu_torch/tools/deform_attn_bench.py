"""K1 and K2, design step by design step, timed in turns on the card.

    python -m bm2f_tpu_torch.tools.deform_attn_bench [--parent-csrc DIR]
        [--design LABEL=DIR ...] [--out output/deform_attn_bench.jsonl]

Times the wrapper calls (the head-major transposes included) of K1 on an
f32 and a bf16 `value` and of K2 on an f32 and a bf16 `value`, on
encoder-like inputs (`deform_inputs`), at the serve shapes (800x800, B=1
and 4; K1) and the train shapes (1024x1024, B=2), for each design:
  runs    tiles of RUN consecutive queries of one head (K1 as it ships);
  cells   encoder cells, every query whose reference point falls in one
          8x8 cell of the finest level (K2 as it ships);
  parent  with --parent-csrc: the kernels and wrappers of another commit,
          for example the parent's `bm2f_tpu_torch` unpacked with `git
          archive` into the git-ignored `_archive/`: DIR is its `csrc/`,
          and DIR/../ops/deform_attn.py the wrapper module that drives it;
  LABEL   each --design, laid out as the parent (a scratch copy of a design
          step, never a build macro in the shipped source).
Each (kernel, shape) runs its designs in order and then in reverse order,
so every design has two CUDA-event means; every design's output is held
against the shipped design's. Then K2's steps apart at the train shapes
(the sample pass, the sort, the reduce; kernel "bwd_stages"). Prints one
JSON line per (kernel, shape, design) and writes them to --out. Needs a
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from bm2f_tpu_torch.ops import cuda_build, deform_attn
from bm2f_tpu_torch.ops.deform_attn import TilePlan, tile_plan

M, D, P = 8, 32, 4
SERVE_SHAPES = ((25, 25), (50, 50), (100, 100))  # 800x800, strides 32, 16, 8
TRAIN_SHAPES = ((32, 32), (64, 64), (128, 128))  # 1024x1024
ITERS = {"fwd": 50, "fwd_bf16": 50, "bwd": 20, "bwd_bf16": 20}


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


def variant_modules(specs):
    """specs: {label: csrc directory}. For each, its wrapper module
    (csrc/../ops/deform_attn.py) loaded on its own, driving the kernels of
    its `csrc/`, all of them built in parallel: {label: module}."""
    sources = (deform_attn._FWD_SOURCE, deform_attn._BWD_SOURCE)
    libs = cuda_build.build_variants({(label, src): Path(csrc) / src
                                      for label, csrc in specs.items() for src in sources})
    mods = {}
    for label, csrc in specs.items():
        path = Path(csrc).parent / "ops" / "deform_attn.py"
        spec = importlib.util.spec_from_file_location(f"deform_attn_{label}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        class Build:  # what the module calls cuda_build
            @staticmethod
            def load(source, label=label):
                return libs[(label, source)]

        mod.cuda_build = Build
        mods[label] = mod
    return mods


def device_tables(plan: TilePlan, dev):
    """`plan` as the wrappers' `_device_plan` gives it, on `dev`."""
    return (*(torch.from_numpy(a).to(dev) for a in plan), len(plan.tile_ptr) - 1)


def call(mod, kernel, shapes, v, loc, attn, g, tables=None):
    """One wrapper call of `kernel` through `mod` (the shipped
    `deform_attn` or a variant), with `tables` from `device_tables` in
    place of its own when given."""
    with contextlib.ExitStack() as stack:
        if tables is not None:
            stack.enter_context(mock.patch.object(mod, "_device_plan", lambda *a: tables))
        if kernel.startswith("bwd"):
            return mod.ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        with torch.no_grad():
            return mod.ms_deform_attn_cuda(v, shapes, loc, attn)


def max_err(a, b) -> float:
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def bench(kernel, shapes, B, variants, gen, dev):
    S = sum(h * w for h, w in shapes)
    v, loc, attn = deform_inputs(B, shapes, S, gen, dev)
    if kernel.endswith("bf16"):
        v = v.to(torch.bfloat16)
    g = torch.randn(B, S, M * D, generator=gen).to(dev) if kernel.startswith("bwd") else None
    calls = {name: (lambda m=mod: call(m, kernel, shapes, v, loc, attn, g))
             for name, mod in variants.items()}
    for name, cells in (("runs", False), ("cells", True)):
        tables = device_tables(tile_plan(shapes, S, cells), dev)
        calls[name] = lambda t=tables: call(deform_attn, kernel, shapes, v, loc, attn, g, t)
    shipped = calls["cells"]()
    outs = {name: fn() for name, fn in calls.items()}
    errs = {name: max_err(out, shipped) for name, out in outs.items()}
    # K2: each gradient apart, and whether it has the shipped design's bits
    parts = {name: {g: {"max_abs": max_err(a, b), "bitwise": bool(torch.equal(a, b))}
                    for g, a, b in zip(("d_value", "d_loc", "d_attn"), out, shipped)}
             for name, out in outs.items()} if kernel.startswith("bwd") else {}
    del outs
    order = list(calls)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(cuda_ms(calls[name], ITERS[kernel]))
    return [{"kernel": kernel, "shapes": "serve" if shapes == SERVE_SHAPES else "train",
             "B": B, "design": name, "ms": [round(t, 4) for t in times[name]],
             "max_abs_vs_cells": errs[name],
             **({"vs_cells": parts[name]} if parts else {})} for name in order]


def bwd_stages(shapes, B, bf16, gen, dev):
    """K2's steps apart, as it ships: the sample pass, the sort, the keys'
    bounds, the reduce (each timed alone on the previous step's output)."""
    S = sum(h * w for h, w in shapes)
    v, loc, attn = deform_inputs(B, shapes, S, gen, dev)
    v = v.to(torch.bfloat16) if bf16 else v
    g = torch.randn(B, S, M * D, generator=gen).to(dev)
    dims = deform_attn._cuda_dims(v, shapes, loc, attn, g, (torch.float32, torch.bfloat16))
    K = len(shapes) * P

    def sample():
        return deform_attn._bwd_sample(v, shapes, loc, attn, g, dims)

    _, _, wa, keys = sample()
    S_pad = deform_attn.padded_size(shapes)

    def sort():
        return deform_attn._radix_order_cuda(keys, S * K, B * M, S_pad)

    order, sorted_keys = sort()

    def bounds():
        return deform_attn._key_bounds(sorted_keys, S * K, B * M, S_pad)

    row_ptr = bounds()
    d_value = torch.empty(v.shape, device=dev, dtype=v.dtype)
    stages = {"sample": sample, "sort": sort, "bounds": bounds,
              "reduce": lambda: deform_attn._bwd_reduce(row_ptr, order, wa, g, d_value, shapes,
                                                        dims)}
    return {"kernel": "bwd_stages", "dtype": "bf16" if bf16 else "f32", "B": B,
            "shapes": "train", "samples": keys.numel(), "valid_corners": int((wa != 0).sum()),
            **{name: round(cuda_ms(fn, ITERS["bwd"]), 4) for name, fn in stages.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=Path, default=None)
    ap.add_argument("--design", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--out", default="output/deform_attn_bench.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("deform_attn_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    specs = dict(d.split("=", 1) for d in args.design)
    if args.parent_csrc:
        specs = {"parent": args.parent_csrc, **specs}
    variants = variant_modules(specs)
    gen = torch.Generator().manual_seed(0)
    lines = []
    for kernel, shapes, B in (("fwd", SERVE_SHAPES, 1), ("fwd", SERVE_SHAPES, 4),
                              ("fwd", TRAIN_SHAPES, 2), ("fwd_bf16", SERVE_SHAPES, 1),
                              ("fwd_bf16", SERVE_SHAPES, 4), ("bwd", TRAIN_SHAPES, 2),
                              ("bwd_bf16", TRAIN_SHAPES, 2)):
        for line in bench(kernel, shapes, B, variants, gen, dev):
            print(json.dumps(line), flush=True)
            lines.append(line)
    for bf16 in (False, True):
        lines.append(bwd_stages(TRAIN_SHAPES, 2, bf16, gen, dev))
        print(json.dumps(lines[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
