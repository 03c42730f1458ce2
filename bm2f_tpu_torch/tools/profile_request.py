"""Where the time of one served request goes, on the card.

    python -m bm2f_tpu_torch.tools.profile_request [--size 800x800] [--repeats 5] \
        [--set model.dtype=bfloat16 --set model.pixel_decoder_f32=False]

Builds `Predictor("coco_instance_r50")` at full width with seeded random
weights (deformable projections perturbed as in `chip_smoke.py`, so sampling
is not on the init's grid), answers one warm-up request, then:
  1. times each step of `Predictor.infer` from its spans (`utils.tracing`,
     on the device's clock; median over --repeats requests): padding and the
     copy in, backbone, pixel decoder, predictor, the resize and the three
     inference modes, the copy to the host, the panoptic relabelling (on the
     host's clock);
  2. profiles one request with `torch.profiler`, writes the op tables to
     --out (default output/profile_request.txt) and prints the device-busy
     share of the profiled request and of the unprofiled median;
  3. with `--cold HxW ...`, for each size not yet served: its first request
     (cold) step by step, the growth of the allocator's reserved memory in
     that request, then the warm median over --repeats requests of that
     size, and the cold request's excess over the warm one per step.
`--set KEY=VALUE` overrides a config field (a Python literal), as the train
entry point's does; the two above give the bench's bf16 serving.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bm2f_tpu_torch.config import parse_override
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.utils import tracing


def perturb_deformable(model, seed: int = 1) -> None:
    """Small seeded weights for the zero-init sampling-offset and attention
    projections, so that the kernel sees general locations."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.sem_seg_head.pixel_decoder.transformer.encoder.layers:
            for lin, std in ((layer.self_attn.sampling_offsets, 0.1),
                             (layer.self_attn.attention_weights, 0.05)):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * std)


# the step table: (row, the span of `Predictor.infer` it reads, its clock)
STEPS = (("prepare", "serve.prepare", "device_ms"), ("backbone", "net.backbone", "device_ms"),
         ("pixel_decoder", "net.pixel_decoder", "device_ms"),
         ("predictor", "net.decoder", "device_ms"), ("modes", "serve.modes", "device_ms"),
         ("to_host", "serve.to_host", "device_ms"), ("relabel", "serve.relabel", "host_ms"))


def request_steps(pred: Predictor, image: np.ndarray) -> dict:
    """One `Predictor.infer` traced (`utils.tracing`): each step's ms from
    its span, on the device's clock (the relabelling, host work, on the
    host's), and the segments found."""
    with tracing.collect():
        out = pred.infer(image)
    spans = tracing.records()[-1]["spans"]
    t = {row: sum(s[clock] for s in spans if s["name"] == name) for row, name, clock in STEPS}
    t["segments"] = len(out["panoptic"][1])
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="800x800")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="output/profile_request.txt")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    ap.add_argument("--cold", nargs="*", default=[], metavar="HxW",
                    help="sizes other than --size: each one's first request, "
                         "then its warm median")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_request: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pred = Predictor()
    pred.setup("coco_instance_r50", device="cuda", seed=0, overrides=dict(args.set))
    perturb_deformable(pred.model)
    image = make_image(args.size)
    pred.predict(image)  # warm-up

    med, segments = warm_median(pred, image, args.repeats)
    print(f"device={torch.cuda.get_device_name(0)!r} size={args.size} "
          f"repeats={args.repeats} segments={segments} "
          f"dtype={pred.cfg.model.dtype} "
          f"pixel_decoder_f32={pred.cfg.model.pixel_decoder_f32}")
    print("steps_ms_median " + steps_line(med))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(image)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    # the profiler slows the host; the medians of the traced requests above
    # (their spans add no synchronise) are the request without it
    print(f"profiled_request wall_ms={wall:.2f} device_busy_ms={dev_us / 1e3:.2f} "
          f"busy_share_of_profiled_request={dev_us / 1e3 / wall:.3f} "
          f"busy_share_of_unprofiled_request={dev_us / 1e3 / sum(med.values()):.3f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    table_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    table_dev = events.table(sort_by="self_device_time_total", row_limit=25)
    Path(args.out).write_text(table_cpu + "\n\n" + table_dev + "\n")
    print(table_cpu.splitlines()[0])
    for line in table_cpu.splitlines()[1:14]:
        print(line)

    for size in args.cold:
        image = make_image(size)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        cold = request_steps(pred, image)
        grown = (torch.cuda.memory_reserved() - reserved) / 2**20
        cold.pop("segments")
        warm, _ = warm_median(pred, image, args.repeats)
        print(f"cold size={size} reserved_growth_mib={grown:.1f} " + steps_line(cold))
        print(f"warm size={size} " + steps_line(warm))
        print(f"cold_excess size={size} "
              + steps_line({k: cold[k] - warm[k] for k in cold}))
    return 0


def make_image(size: str) -> np.ndarray:
    """A seeded random (H, W, 3) uint8 image of `size` "HxW"."""
    h, w = (int(v) for v in size.split("x"))
    return np.random.RandomState(0).randint(0, 256, (h, w, 3)).astype(np.uint8)


def warm_median(pred: Predictor, image: np.ndarray, repeats: int):
    """({step: median ms over `repeats` timed requests}, segments found)."""
    runs = [request_steps(pred, image) for _ in range(repeats)]
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0] if k != "segments"}
    return med, runs[0]["segments"]


def steps_line(steps: dict) -> str:
    return (" ".join(f"{k}={v:.2f}" for k, v in steps.items())
            + f" total={sum(steps.values()):.2f}")


if __name__ == "__main__":
    sys.exit(main())
