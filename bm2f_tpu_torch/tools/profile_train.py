"""Where the device time of one train step goes, on the card.

    python -m bm2f_tpu_torch.tools.profile_train [--out output/profile_train.txt]
        [--config coco_instance_r50] [--instances 8] [--set KEY=VALUE ...]

Builds `Trainer(--config)` at full width with seeded random weights, with
`--set` overrides as the train entry point takes them (the JAX train
bench's bf16 step: `--set model.dtype=bfloat16 --set
model.pixel_decoder_f32=False --set train.matcher=jv`) (deformable
projections perturbed as in `chip_smoke.py`) and `chip_smoke.py`'s train
batch (B=2, 1024x1024, `--instances` targets per image, the last 2 of
image 0 padding; the box-supervised presets take the same batch), takes
one warm-up step, times 5 steps without the profiler (host clock, each
ending in a synchronise), then profiles one step with `torch.profiler`.
Prints the unprofiled step time (median) and the profiled one, the peak
allocated memory of the unprofiled steps, the device time summed over every
kernel and copy, the device-busy share against each step time, K1's and
K2's device time, and writes the op tables to --out.
The split of a step by stage is `chip_smoke.py`'s `[train_stages]` line.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

from bm2f_tpu_torch.config import get_config, parse_override
from bm2f_tpu_torch.tools.profile_request import perturb_deformable
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

# each kernel's device functions, its call counted by the first: K2 is a
# sample pass, a radix sort (two kernels a pass), the keys' bounds and a
# reduce (the sort's scans of per-block counts are PyTorch's cumsum, not
# counted here)
KERNELS = {"K1": ("ms_deform_attn_fwd_kernel",),
           "K2": ("ms_deform_attn_bwd_sample_kernel", "radix_count_kernel",
                  "radix_scatter_kernel", "key_bounds_kernel",
                  "ms_deform_attn_bwd_reduce_kernel")}
UNPROFILED_STEPS = 5


def timed_step(trainer: Trainer, batch) -> float:
    """Host-clock ms of one step, from an idle device to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/profile_train.txt")
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = get_config(args.config, dict(args.set))
    trainer = Trainer(cfg, device=dev, seed=0)
    perturb_deformable(trainer.model)
    batch = synthetic_batch(2, 1024, args.instances, seed=0, device=dev)
    timed_step(trainer, batch)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    plain = [timed_step(trainer, batch) for _ in range(UNPROFILED_STEPS)]
    step_ms = statistics.median(plain)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_step(trainer, batch)
    events = prof.key_averages()
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    n_ops = sum(e.count for e in dev_events)
    print(f"device={torch.cuda.get_device_name(0)!r} config={args.config} "
          f"sup_type={cfg.model.loss.sup_type} batch=2 size=1024 "
          f"instances={args.instances} dtype={cfg.model.dtype} "
          f"pixel_decoder_f32={cfg.model.pixel_decoder_f32} matcher={cfg.train.matcher}")
    print("unprofiled_steps_ms " + " ".join(f"{t:.2f}" for t in plain)
          + f" median={step_ms:.2f} peak_mem_gib={peak_gib:.2f}")
    print(f"profiled_step_ms={profiled_ms:.2f} profiler_overhead_ms="
          f"{profiled_ms - step_ms:.2f} device_busy_ms={busy_ms:.2f} device_ops={n_ops} "
          f"busy_share_of_unprofiled_step={busy_ms / step_ms:.3f} "
          f"busy_share_of_profiled_step={busy_ms / profiled_ms:.3f}")
    for tag, names in KERNELS.items():
        mine = [e for e in dev_events if any(name in e.key for name in names)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        calls = sum(e.count for e in mine if names[0] in e.key)
        print(f"{tag} {'+'.join(names)} launches={calls} device_functions="
              f"{sum(e.count for e in mine)} device_ms={ms:.3f} "
              f"share_of_busy={ms / max(busy_ms, 1e-9):.4f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    table_dev = events.table(sort_by="self_device_time_total", row_limit=40)
    table_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    Path(args.out).write_text(table_dev + "\n\n" + table_cpu + "\n")
    for line in table_dev.splitlines()[:18]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
