"""The readings a cell's limits are set from, on the card at the cell's own
size. Not run by the benchmark's runs:

    python3 -m port_bench.calibrate --workload <name> --seeds <n> ... \\
        [--controls K] [--program-f32] [--out chiprun_out/calib_<name>.jsonl]

For every seed, the program as a run drives it: set-up (for a train cell,
the checked steps) or, for a served cell, requests until every shape has
been served, then the check against the f32 reference ("program"). For
the first K seeds also:
- "control": the reference put in the program's place, computed in the
  precision below the configuration's (`reference.numerics`: fp8 for the
  bf16 training step, TF32 products for f32 serving), against the f32
  reference;
- for a train cell, "half_batch": the reference on the first half of each
  batch (its loss the mean over that half), against the whole batch's;
  and "state_unchanged": the reference with a learning rate of 0 (its
  weights unchanged by every step), its first gradient read as 0 (the
  AdamW state unchanged too).
`--program-f32` runs a train cell's program in float32 instead of its
configuration's precision: a second witness for a reading of the program
that stands out. Prints one JSON line per reading, and last each number's
lower reading (the widest "program" one) and the least reading of the
control and of each fault.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time

import torch

from port_bench import check, harness, manifest
from port_bench.reference.numerics import Numerics
from port_bench.weights import make_weights

# the precisions below each configuration precision that a control takes
CONTROL = {"bfloat16": ("fp8",), "float16": ("fp8",), "float32": ("tf32",)}


def as_prog(rec) -> dict:
    return {"total": rec.total, "losses": rec.losses, "grad_norm": rec.grad_norm,
            "grad1": rec.grad1, "change": rec.change, "out1": rec.out1}


def worst_leaves(kind, prog, ref, n=3) -> None:
    """Prints the weights of the widest first-gradient and change gaps, and
    each step's loss gap (to standard error), for the look at a reading."""
    g1 = check.leaf_gaps(prog["grad1"], ref.grad1)
    ch = check.leaf_gaps(prog["change"], ref.change, check.moving(ref))
    top = lambda d: [(k, round(v, 5), ref.grad1[k]) for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:n]]
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["total"], ref.total)]
    print(json.dumps({"kind": kind, "grad1_worst": top(g1), "change_worst": top(ch),
                      "loss_gap_by_step": steps}), file=sys.stderr, flush=True)


def train_readings(drv, with_controls: bool):
    drv.setup()
    numbers, ref = drv.check()
    out = [("program", numbers)]
    worst_leaves("program", drv.prog, ref)
    if with_controls:
        batches, opt = drv.ref_inputs
        out += reference_readings(drv, batches, drv.check_points, opt, ref)
    return out


def reference_readings(drv, batches, points, opt, ref=None):
    """The control and the faults, each the reference with the change,
    against the f32 reference (`ref`, computed here when None)."""
    from port_bench.reference.train import train_steps

    P0 = make_weights(drv.arch, drv.weights_seed, drv.device)
    run = lambda b, p, o=opt, **kw: train_steps(P0, b, p, drv.arch, drv.lw, o, drv.weak, **kw)
    if ref is None:
        ref = run(batches, points)
    out = []
    for kind in CONTROL[drv.conf["train_precision"]]:
        ctrl = run(batches, points, numerics=Numerics(kind))
        out.append((f"control_{kind}", check.train_numbers(as_prog(ctrl), ref)))
        worst_leaves(f"control_{kind}", as_prog(ctrl), ref)
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
    pts = [None if p is None else {k: v[:, : v.shape[1] // 2] for k, v in p.items()}
           for p in points]
    out.append(("half_batch", check.train_numbers(as_prog(run(half, pts)), ref)))
    still = as_prog(run(batches, points, dataclasses.replace(opt, base_lr=0.0)))
    still["grad1"] = {k: 0.0 for k in still["grad1"]}  # its AdamW state unchanged too
    out.append(("state_unchanged", check.train_numbers(still, ref)))
    return out


def program_f32(c: manifest.Cell) -> manifest.Cell:
    """The cell with its train step in float32."""
    c = copy.copy(c)
    c.config = copy.deepcopy(c.config)
    c.config["train_overrides"]["model.dtype"] = "float32"
    c.config["train_precision"] = "float32"
    return c


def serve_readings(drv, with_controls: bool):
    from port_bench.reference.serve import infer

    drv.setup()
    while not all(drv.seen):
        drv.request()
    numbers, _ = drv.check()
    out = [("program", numbers)]
    by_request = {"program": [r["answer_gap"] for r in drv.rows]}
    if with_controls:
        P0 = make_weights(drv.arch, drv.weights_seed, drv.device)
        kind, = CONTROL[drv.conf["serve_precision"]]
        test = drv.conf["test"]
        rows = []
        for s, k in drv.samples:
            img = drv.images[s][k]
            kw = dict(device=drv.device, object_mask_threshold=test["object_mask_threshold"],
                      overlap_threshold=test["overlap_threshold"])
            ref = infer(P0, img, drv.arch, **kw)
            ctrl = infer(P0, img, drv.arch, numerics=Numerics(kind), **kw)
            prog = {"pred_logits": ctrl["pred_logits"], "pred_masks": ctrl["pred_masks"],
                    "semantic": ctrl["semantic"].cpu().numpy(),
                    "instances": {k2: v.cpu().numpy() for k2, v in ctrl["instances"].items()},
                    "panoptic": (ctrl["panoptic"][0].cpu().numpy(), ctrl["panoptic"][1])}
            rows.append(check.serve_numbers(prog, ref, drv.arch.num_classes))
        out.append((f"control_{kind}", check.served(rows)))
        by_request[f"control_{kind}"] = [r["answer_gap"] for r in rows]
    print(json.dumps({"seed": drv.seed, "answer_gap_by_request": by_request}), file=sys.stderr,
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--program-f32", action="store_true",
                    help="run a train cell's program in float32 (a second witness)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    c = manifest.cell(args.workload)
    if args.program_f32:
        c = program_f32(c)
    readings = {}
    lines = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = harness.DRIVERS[c.mix["driver"]](c, seed, "cuda")
        fn = train_readings if c.mix["driver"] == "train" else serve_readings
        readings_of = fn(drv, i < args.controls)
        for kind, nums in readings_of:
            line = {"workload": args.workload, "seed": seed, "kind": kind, **nums,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
            readings.setdefault(kind, []).append(nums)
        del drv
        harness.free("cuda")
    summary = {"workload": args.workload,
               "lower": check.worst(readings["program"]) if "program" in readings else {},
               "least": {kind: {k: min(r[k] for r in rs) for k in rs[0]}
                         for kind, rs in readings.items() if kind != "program"},
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
