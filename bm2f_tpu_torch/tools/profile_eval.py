"""Where the time of the eval goes, on the card: the host against the device.

    python -m bm2f_tpu_torch.tools.profile_eval [--evaluator coco] \\
        [--out output/profile_eval.txt] [--set KEY=VALUE ...]

Writes `chip_smoke.py`'s synthetic dataset (`data/synthetic.py`, COCO val2017
sizes; 4 images in the 1344 bucket, 3 in the 992 one) to a temporary
directory, builds `coco_instance_r50` at full width with seeded random
weights (deformable projections perturbed as in `chip_smoke.py`), and runs
`bm2f_tpu_torch.eval.run_eval` with the evaluator of `--evaluator` (coco,
sem_seg or coco_panoptic_seg):
  1. a first pass (each bucket's first image pays the libraries' algorithm
     choice), then a timed pass: each image's host-clock time, from its
     batch to the end of its evaluation (`run_eval`'s `timings`), and the
     pass's wall time per image, which adds reading and resizing the image
     (the loader);
  2. a profiled pass with `torch.profiler`: the device time summed over
     every kernel and copy, per image, against the timed pass's per-image
     time (the device-busy share; the rest is the host's: launches, the
     copies' waits, the evaluator), K1's device time, and the op tables in
     --out.
`--set` overrides a config field (`--set model.dtype=bfloat16 --set
model.pixel_decoder_f32=False` for the bf16 model). Needs a card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from bm2f_tpu_torch import eval as port_eval
from bm2f_tpu_torch.config import parse_override
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import COCO_SIZES, write_synthetic_coco
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.tools.profile_request import perturb_deformable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evaluator", default="coco",
                    choices=("coco", "sem_seg", "coco_panoptic_seg"))
    ap.add_argument("--out", default="output/profile_eval.txt")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="profile_eval_")
    try:
        names = write_synthetic_coco(root, COCO_SIZES, seed=0)
        register_all_builtin_datasets(root, force=True)
        dataset = next(n for n, t in names.items() if t == args.evaluator)
        pred = Predictor()
        pred.setup("coco_instance_r50", device="cuda", seed=0, overrides=dict(args.set))
        perturb_deformable(pred.model)
        first = []
        port_eval.run_eval(pred.cfg, pred.model, dataset, timings=first)
        timed = []
        t0 = time.perf_counter()
        port_eval.run_eval(pred.cfg, pred.model, dataset, timings=timed)
        wall_s = time.perf_counter() - t0

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            port_eval.run_eval(pred.cfg, pred.model, dataset)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = len(timed)
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / n
    k1_ms = sum(e.self_device_time_total for e in dev_events
                if "ms_deform_attn_fwd_kernel" in e.key) / 1e3 / n
    image_ms = sum(t["ms"] for t in timed) / n
    print(f"device={torch.cuda.get_device_name(0)!r} evaluator={args.evaluator} images={n} "
          f"dtype={pred.cfg.model.dtype} pixel_decoder_f32={pred.cfg.model.pixel_decoder_f32}")
    for label, run in (("first_pass", first), ("timed_pass", timed)):
        print(label + " " + " ".join(f"b{t['bucket']}={t['ms']:.2f}" for t in run))
    print(f"per_image image_ms_mean={image_ms:.2f} device_busy_ms={busy_ms:.2f} "
          f"busy_share={busy_ms / image_ms:.3f} host_ms={image_ms - busy_ms:.2f} "
          f"k1_device_ms={k1_ms:.3f} wall_ms_per_image={wall_s * 1e3 / n:.2f} "
          f"profiled_pass_s={profiled_s:.2f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    table_dev = events.table(sort_by="self_device_time_total", row_limit=30)
    table_cpu = events.table(sort_by="self_cpu_time_total", row_limit=30)
    Path(args.out).write_text(table_dev + "\n\n" + table_cpu + "\n")
    for line in table_cpu.splitlines()[:16]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
