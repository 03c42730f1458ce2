"""K1, the deformable-attention forward, taken apart at the encoder's
shapes (the JAX package's tools/profile_kernel.py, on the port).

    python -m bm2f_tpu_torch.tools.profile_kernel [--batch 4] [--size 800] \\
        [--iters 20] [--device cuda]

Inputs as the JAX tool's: B=4, the levels of an 800x800 image (100x100,
50x50, 25x25), M=8, D=32, L=3, P=4, Q=S, a head-major bf16 `value` (B, M,
S, D), uniform f32 locations and softmaxed f32 attention weights
(`tools.deform_attn_bench.deform_inputs`, seed 0). Three views, each timed with CUDA
events over --iters back-to-back calls after a warm-up, in ns per sample:
  - the full call: the head-major `value` laid out as the wrapper takes it
    (B, S, M, D), then `ms_deform_attn_cuda` (its checks, the output, the
    tile plan on the device, the launch);
  - the preparation alone: that layout and `ops.deform_attn.prepare_fwd`
    (the checks, the output's allocation, the tile plan, built once per
    shape and then looked up);
  - the launch alone: `ops.deform_attn.launch_fwd` on prepared buffers.
The launch alone's output must be bitwise the full call's. The JAX tool
also sweeps its Pallas `q_tile` (128-1024 queries); the port's tile is
fixed: runs of `ops.deform_attn.RUN` consecutive queries of one head a
block of a compile-time number of warps (`kWarpsPerBlock`,
csrc/ms_deform_attn_common.cuh), with L, P and D instantiated at compile
time (the template arguments of csrc/ms_deform_attn_fwd.cu). A tile is a
design, not a flag: other designs are compared in turns by
`tools/deform_attn_bench.py --design`. Both constants are printed.
On the CPU (--device cpu, host clock) the three views are the plain
version's layout, nothing, and `ms_deform_attn_plain`.
"""

from __future__ import annotations

import argparse
import re

import torch

from bm2f_tpu_torch.ops import cuda_build, deform_attn
from bm2f_tpu_torch.tools.deform_attn_bench import M, P, deform_inputs

L = 3


def warps_per_block() -> int:
    """kWarpsPerBlock as csrc/ms_deform_attn_common.cuh defines it."""
    src = (cuda_build.CSRC_DIR / "ms_deform_attn_common.cuh").read_text()
    return int(re.search(r"constexpr int kWarpsPerBlock = (\d+);", src)[1])


def main(argv=None) -> dict:
    from bm2f_tpu_torch.tools.device import timed_ms, tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain version)")
    args = ap.parse_args(argv)

    dev = tool_device("profile_kernel", args.device)
    B = args.batch
    shapes = tuple((args.size // s, args.size // s) for s in (8, 16, 32))
    S = sum(h * w for h, w in shapes)
    value, loc, attn = deform_inputs(B, shapes, S, torch.Generator().manual_seed(0), dev,
                                     loc_range=(0.0, 1.0))
    value_hm = value.transpose(1, 2).contiguous().to(torch.bfloat16)  # (B, M, S, D)
    ndesc = B * S * M * L * P
    print(f"query tile: RUN={deform_attn.RUN} consecutive queries of one head a block of "
          f"{warps_per_block()} warps (kWarpsPerBlock); no q_tile sweep", flush=True)

    def layout():
        return value_hm.transpose(1, 2).contiguous()

    if dev.type == "cuda":
        def full():
            return deform_attn.ms_deform_attn_cuda(layout(), shapes, loc, attn)

        def prep():
            return deform_attn.prepare_fwd(layout(), shapes, loc, attn)

        call = prep()

        def kernel():
            return deform_attn.launch_fwd(call)
    else:
        def full():
            return deform_attn.ms_deform_attn_plain(layout(), shapes, loc, attn)

        value = layout()
        prep = layout

        def kernel():
            return deform_attn.ms_deform_attn_plain(value, shapes, loc, attn)

    with torch.no_grad():
        ms = {name: timed_ms(fn, args.iters, dev=dev)
              for name, fn in (("full", full), ("prep", prep), ("kernel", kernel))}
        out_full = full().clone()
        out_kernel = kernel().clone()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    bitwise = torch.equal(out_full, out_kernel)
    for name, label in (("full", "full call"), ("prep", "prep (layout, plan)"),
                        ("kernel", "launch alone")):
        print(f"{label}: {ms[name]:.4f} ms ({ms[name] * 1e6 / ndesc:.3f} ns/desc)", flush=True)
    print(f"launch alone bitwise the full call: {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError("profile_kernel: the launch alone differs from the full call")
    return {"ms": ms, "ndesc": ndesc, "bitwise": bitwise}


if __name__ == "__main__":
    main()
