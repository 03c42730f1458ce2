"""The data-parallel (and tensor-parallel) train step on the card: its
losses against one card on the same global batch, its time against one
card's step on a rank's share, the all-reduces' share of the step, and
peak memory and state bytes per card.

    python -m torch.distributed.run --nproc-per-node 4 -m bm2f_tpu_torch.tools.ddp_bench \\
        --out chiprun_out/ddp_w4.json
    python -m bm2f_tpu_torch.tools.ddp_bench --single --out chiprun_out/ddp_w1.json
    python -m bm2f_tpu_torch.tools.ddp_bench --compare chiprun_out/ddp_w1.json \\
        chiprun_out/ddp_w4.json [chiprun_out/ddp_w4_again.json]

Under the launcher each rank starts NCCL (`parallel.init_distributed`) and
trains `Trainer(--config)` at full width from seed 0 (deformable
projections perturbed as in `chip_smoke.py`) on its rows of a seeded
synthetic global batch of `--ims-per-batch` images at `--size` with
`--instances` targets each, a new batch a step (`trainer.synthetic_batch`
from seed i), for `--steps` steps, each timed on the host clock between
synchronises, then profiles `--profile-steps` more with `torch.profiler`
for the device time of NCCL's kernels and of all kernels and copies. Rank
0 writes one JSON object: every step's metrics (the global ones), the step
times, every rank's peak allocated memory, the all-reduce's device ms a
step, and a SHA-256 of the parameters after the steps. `--single` runs one process with no group on
the whole global batch (the reference of the losses), then the same steps
on a rank's share (`--ims-per-batch` / `--share-of` images, the work of one
card) for the time. `--compare` holds the runs' first step against the
single run's within `REL` and says whether two multi-card runs are bitwise
equal. Needs cards; exits non-zero without one.

`--model T` lays the ranks out as the (data, model) mesh with model T
(`parallel.init_mesh`; `mesh.model` of the config): each data rank trains
`--ims-per-batch / (world / T)` images on its share of the wide
parameters. The parameters' hash is then the gathered state's, equal on
every rank, and `state_bytes` is the rank's parameters and AdamW moments.
`--compare` also takes a multi-card run as its reference (the first
file), so that runs at several meshes compare with each other.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.parallel import init_distributed, local_rows, rank, world_size
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.tools.profile_request import perturb_deformable
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

# the first step's losses and grad_norm at W ranks against one card on the
# global batch: the sums of f32 terms in another order (each card's batch is
# a quarter of one card's, so cuDNN's and cuBLAS's kernels may block their
# sums otherwise, and the gradients add across cards); the CPU's SMALL step
# reads up to 1.2e-5 of a tensor's norm between world sizes
# (tests/torch_ddp_cases.py), held at 1e-4 as there
REL = 1e-4


def smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not available"


def params_sha(trainer: Trainer) -> str:
    """The whole parameters' hash (gathered under tensor parallelism: every
    rank of a model group calls it)."""
    params = {n: p.detach() for n, p in trainer.model.named_parameters()}
    if trainer.shard is not None:
        params = tparallel.gather_state(params, trainer.splits, trainer.shard)
    h = hashlib.sha256()
    for name, p in params.items():
        h.update(name.encode())
        h.update(p.cpu().numpy().tobytes())
    return h.hexdigest()


def state_bytes(trainer: Trainer) -> int:
    """This rank's parameters and both AdamW moments, in bytes."""
    opt = trainer.optimizer
    return sum(t.numel() * t.element_size() for ts in (opt.params, opt.mu, opt.nu)
               for t in ts)


def run_steps(trainer: Trainer, args, global_batch: int, share: int = 1) -> dict:
    """`args.steps` timed steps on this rank's rows of the global batches
    (or on their first `global_batch / share` images), then the profiled
    ones. Returns the metrics, times, peak memory and NCCL device time."""
    dev = trainer.device

    def batch(i):
        b = synthetic_batch(global_batch, args.size, args.instances, seed=i,
                            num_classes=trainer.cfg.model.num_classes, device="cpu")
        b = local_rows(b) if share == 1 else {k: v[:global_batch // share]
                                               for k, v in b.items()}
        return {k: v.to(dev) for k, v in b.items()}

    metrics, ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(args.steps):
        b = batch(i)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = trainer.step(b)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps, args.steps + args.profile_steps):
            trainer.step(batch(i))
        torch.cuda.synchronize(dev)
    # the device's own events (kernels, copies), each once; NCCL's kernels
    # run on their own stream, beside the backward's
    nccl_us = device_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        device_us += us
        if "nccl" in e.name.lower():
            nccl_us += us
    return {"metrics": metrics, "step_ms": ms,
            "step_ms_median": statistics.median(ms[1:] if len(ms) > 1 else ms),
            "peak_gib": peak,
            "nccl_ms_per_step": nccl_us / 1e3 / max(args.profile_steps, 1),
            "device_ms_per_step": device_us / 1e3 / max(args.profile_steps, 1)}


def make_trainer(args, device) -> Trainer:
    trainer = Trainer(get_config(args.config, {"mesh.model": args.model}), device=device,
                      seed=0)
    perturb_deformable(trainer.model)
    return trainer


def compare(single_path: str, *multi_paths: str) -> dict:
    """The multi-card runs' first step against the single run's on the
    global batch (raises beyond `REL`), and whether the multi-card runs are
    bitwise equal to each other (metrics and parameters)."""
    ref = json.loads(Path(single_path).read_text())
    single = (ref["global"] if "global" in ref else ref)["metrics"][0]
    runs = [json.loads(Path(p).read_text()) for p in multi_paths]
    worst = {}
    for run in runs:
        for k, v in run["metrics"][0].items():
            rel = abs(v - single[k]) / max(abs(single[k]), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
    key = max(worst, key=worst.get)
    out = {"max_rel_vs_single": worst[key], "max_rel_key": key, "rel_bound": REL,
           "bitwise_equal_runs": (len(runs) > 1 and all(
               r["metrics"] == runs[0]["metrics"] and r["params_sha256"]
               == runs[0]["params_sha256"] for r in runs[1:]))}
    if not worst[key] <= REL:
        raise AssertionError(f"{key}: {worst[key]:.3e} from one card beyond {REL}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--ims-per-batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--single", action="store_true",
                    help="one process: the global batch, then a rank's share")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis (tensor parallelism), mesh.model")
    ap.add_argument("--share-of", type=int, default=4,
                    help="--single: the world whose per-card share is timed")
    ap.add_argument("--compare", nargs="+", metavar="JSON",
                    help="the single run's JSON, then the multi-card runs'")
    ap.add_argument("--out", default="output/ddp_bench.json")
    args = ap.parse_args(argv)
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("ddp_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.single:
        dev = torch.device("cuda")
        res = {"world": 1, "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi()}
        trainer = make_trainer(args, dev)
        res["global"] = run_steps(trainer, args, args.ims_per_batch)
        del trainer
        torch.cuda.empty_cache()
        trainer = make_trainer(args, dev)
        res["share"] = run_steps(trainer, args, args.ims_per_batch, share=args.share_of)
        res["share"]["images"] = args.ims_per_batch // args.share_of
    else:
        dev = init_distributed("cuda")
        trainer = make_trainer(args, dev)
        got = run_steps(trainer, args, args.ims_per_batch)
        sha = params_sha(trainer)
        shas, peaks, nbytes = ([None] * world_size() for _ in range(3))
        torch.distributed.all_gather_object(shas, sha)
        torch.distributed.all_gather_object(peaks, got["peak_gib"])
        torch.distributed.all_gather_object(nbytes, state_bytes(trainer))
        if len(set(shas)) != 1:
            raise AssertionError(f"the ranks' parameters differ: {shas}")
        mesh = trainer.mesh
        res = {"world": world_size(), "mesh": [mesh.data_size, mesh.model_size],
               "config": args.config, "ims_per_batch": args.ims_per_batch,
               "device": torch.cuda.get_device_name(dev),
               "nvidia_smi": smi(), **got, "peak_gib_by_rank": peaks,
               "state_bytes_by_rank": nbytes, "params_sha256": sha,
               "images_per_s": args.ims_per_batch / got["step_ms_median"] * 1e3}
    if rank() == 0:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res))
        summary = res.get("global", res)
        print(json.dumps({"world": res["world"], "mesh": res.get("mesh"),
                          "step_ms": summary["step_ms"],
                          "images_per_s": res.get("images_per_s"),
                          "state_bytes": res.get("state_bytes_by_rank"),
                          "peak_gib": summary["peak_gib"],
                          "nccl_ms_per_step": summary["nccl_ms_per_step"],
                          "first_step": summary["metrics"][0].get("total_loss")}), flush=True)
    if not args.single:
        torch.distributed.destroy_process_group()
    if not all(np.isfinite(v) for m in res.get("global", res)["metrics"] for v in m.values()):
        raise AssertionError("a metric is not finite")
    return 0


if __name__ == "__main__":
    sys.exit(main())
