"""Train entry point of the port. A quick run of N timed steps:

    python -m bm2f_tpu_torch.train --config coco_instance_r50 --steps 3 \\
        --batch 2 --size 1024 --instances 8 --seed 0 --device cuda

prints one line per step (every loss of the final layer, total_loss,
grad_norm and the step time, each step waited for). With `--max-iter N` or
`--resume` it trains as the JAX package's train.py does
(`train.loop.run_train_loop`): no per-step synchronise, the console, JSON
(`<output>/metrics.json`) and TensorBoard writers every `train.log_period`
steps, a checkpoint under `<output>/checkpoints` every
`train.checkpoint_period` steps and at the end; `--resume` continues from
the latest checkpoint there:

    python -m bm2f_tpu_torch.train --max-iter 20 --output out \\
        --set train.checkpoint_period=10
    python -m bm2f_tpu_torch.train --max-iter 40 --output out --resume

The model has seeded random weights and the data are seeded synthetic
batches in the JAX bench's recipe (`trainer.synthetic_batch`), a new one a
step; dataset loading is a later slice. `--set KEY=VALUE` overrides a
config field (a Python literal): the JAX train bench's bf16 step is
`--set model.dtype=bfloat16 --set model.pixel_decoder_f32=False
--set train.matcher=jv`; a small model on the CPU:

    python -m bm2f_tpu_torch.train --device cpu --size 64 --batch 1 \\
        --instances 3 --set model.backbone.resnet.depth=14 \\
        --set model.decoder.num_queries=10
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from bm2f_tpu_torch.config import get_config, parse_override, update
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.train.loop import run_train_loop, synthetic_loader
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.events import (
    ConsoleWriter,
    EventStorage,
    JSONWriter,
    TensorBoardWriter,
    WandBWriter,
)


def quick_run(trainer: Trainer, args) -> None:
    batch = synthetic_batch(args.batch, args.size, args.instances, args.seed,
                            trainer.cfg.model.num_classes, device=args.device)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        m = {k: float(v) for k, v in metrics.items()}  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        print(f"step {i} total_loss {m['total_loss']:.4f} "
              f"loss_ce {m['loss_ce']:.4f} loss_mask {m['loss_mask']:.4f} "
              f"loss_dice {m['loss_dice']:.4f} grad_norm {m['grad_norm']:.4f} "
              f"step_ms {ms:.1f}", flush=True)


def train(trainer: Trainer, args) -> int:
    """The JAX package's train.py main, on synthetic data: resume, writers,
    the loop. Returns the last iteration."""
    cfg = trainer.cfg
    ckpt = Checkpointer(os.path.join(args.output, "checkpoints"))
    start = ckpt.resume_or_load(trainer, resume=args.resume)
    if start is not None:
        print(f"resumed from step {start} in {ckpt.directory}", flush=True)
    loader = synthetic_loader(args.batch, args.size, args.instances, args.seed,
                              cfg.model.num_classes, start=trainer.step_count)
    writers = [
        ConsoleWriter(cfg.train.log_period),
        JSONWriter(os.path.join(args.output, "metrics.json"), cfg.train.log_period),
        TensorBoardWriter(os.path.join(args.output, "tb"), cfg.train.log_period),
    ]
    if args.wandb:
        writers.append(WandBWriter())
    it = run_train_loop(cfg, trainer, loader, next(loader), ckpt, EventStorage(), writers)
    print(f"training done at iter {it}", flush=True)
    return it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--steps", type=int, default=None,
                    help="quick run: N timed steps, nothing saved (default 3)")
    ap.add_argument("--max-iter", type=int, default=0,
                    help="train to this iteration (train.optimizer.max_iter)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint under --output")
    ap.add_argument("--output", default="./output")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    looped = bool(args.max_iter or args.resume)
    if looped and args.steps is not None:
        ap.error("--steps is the quick run; --max-iter and --resume train in the loop")
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = get_config(args.config, dict(args.set))
    if args.max_iter:
        cfg = update(cfg, {"train.optimizer.max_iter": args.max_iter})
    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    if looped:
        train(trainer, args)
    else:
        args.steps = 3 if args.steps is None else args.steps
        quick_run(trainer, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
