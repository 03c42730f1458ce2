"""Train entry point of the port, the counterpart of the root train.py.

Training on a registered dataset (the loop, `train.loop.run_train_loop`):

    python -m bm2f_tpu_torch.train --config coco_instance_r50_wo_lsj_projpair \\
        --dataset coco_2017_train [--eval-dataset coco_2017_val] \\
        [--data-root DIR] --max-iter N --output out [--resume]

registers the builtin splits under `--data-root` (else
`$DETECTRON2_DATASETS`, else ./datasets) and reads `--dataset` through the
config's mapper (`input.dataset_mapper`, seeded with `train.seed`) and
`build_train_loader`, `train.ims_per_batch` images a step (the global
batch; see `--distributed`). As the JAX package's train.py, the
loop dispatches no per-step synchronise; the console, JSON
(`<output>/metrics.json`) and TensorBoard writers run every
`train.log_period` steps; a checkpoint goes under `<output>/checkpoints`
every `train.checkpoint_period` steps and at the end; with
`--eval-dataset`, `run_eval` (track AP, `run_video_eval`, for a video
config) runs every `train.eval_period` steps before the last and its
metrics go to the writers as `eval/<key>` at that iteration. `--resume`
continues from the latest checkpoint there (the dataset's stream starts
again from its seed, as in JAX). `--eval-only`
evaluates the model (after `--resume`, the latest checkpoint's) on
`--eval-dataset`, else `--dataset`, and prints its metrics. Box-supervised
training is the config's `model.loss.sup_type` (the `*_proj` and
`*_projpair` presets). `--profile` traces steps 10-15 with
`torch.profiler` into `<output>/profile` (root train.py's `--profile`).

Data-parallel training (root train.py `--distributed`) runs one process
per card under PyTorch's launcher:

    python -m torch.distributed.run --nproc-per-node 4 -m bm2f_tpu_torch.train \
        --distributed --config coco_instance_r50 --dataset coco_2017_train ...

Each rank starts the process group from the launcher's environment
(`parallel.init_distributed`: NCCL on its card `cuda:LOCAL_RANK`, or gloo
with `--device cpu`; a missing variable or a failed NCCL start raises) and
trains `train.ims_per_batch // world` images a step through the sampler's
`rank::world` shard (raising when the world does not divide the batch, as
root train.py:207-209 asserts); `--synthetic` draws the global `--batch`
and each rank takes its rows. The step is the JAX package's step on the
global batch (`train/trainer.py`). Rank 0 writes the metrics, the
TensorBoard events and the checkpoints; the other ranks wait for each
save. The evaluation (`--eval-dataset`, `--eval-only`) runs on every rank,
each on its shard of the dataset, and gathers the evaluators.

Tensor parallelism is the JAX package's `mesh.model` axis:

    python -m torch.distributed.run --nproc-per-node 4 -m bm2f_tpu_torch.train \
        --distributed --set mesh.model=2 ...

lays the 4 ranks out as (data 2, model 2) (`parallel.init_mesh`, rank r at
data r // 2, model r % 2): the batch and the loader's shard go by the data
rank (`ims_per_batch // data` images a step, raising when the data size
does not divide the batch or `mesh.model` the world), and the wide
transformer parameters and their moments split over the model group
(`parallel.tp`). The checkpoints hold the whole state, so a run resumes at
any `mesh.model`; the evaluation runs on a whole model on the gathered
weights.

Video training is a `ytvis*` preset on a YouTube-VIS split (`data/ytvis.py`
registers them under the same root): clips of `input.sampling_frame_num`
frames through the `ytvis` mapper, or, when the sup_type holds the temporal
pairwise loss, through `ytvis_with_feats` as root train.py:198-201 builds
it: without a features root, so that its DINO grids are zeros (said once in
the log) and the temporal pairs come from ties, as in the JAX package.

`--synthetic` trains in the loop on seeded synthetic batches in the JAX
bench's recipe (`trainer.synthetic_batch`, `--batch`, `--size`,
`--instances`), a new one a step, so that a resumed run reads what an
uninterrupted one would. Without `--max-iter`, `--resume` or `--eval-only`
the entry point is a quick run of N timed steps on one synthetic batch:

    python -m bm2f_tpu_torch.train --config coco_instance_r50 --steps 3 \\
        --batch 2 --size 1024 --instances 8 --seed 0 --device cuda

which prints one line per step (every loss of the final layer, total_loss,
grad_norm and the step time, each step waited for). The model has seeded
random weights (`--seed`). `--set KEY=VALUE` overrides a config field (a
Python literal): the JAX train bench's bf16 step is
`--set model.dtype=bfloat16 --set model.pixel_decoder_f32=False
--set train.matcher=jv`; a small model on the CPU:

    python -m bm2f_tpu_torch.train --device cpu --size 64 --batch 1 \\
        --instances 3 --set model.backbone.resnet.depth=14 \\
        --set model.decoder.num_queries=10
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from bm2f_tpu_torch.config import get_config, parse_override, update
from bm2f_tpu_torch.parallel import init_distributed, local_rows, rank, world_size
from bm2f_tpu_torch.train.checkpoint import Checkpointer
from bm2f_tpu_torch.train.loop import dispatch_eval, run_train_loop, synthetic_loader
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.events import (
    ConsoleWriter,
    EventStorage,
    JSONWriter,
    TensorBoardWriter,
    WandBWriter,
)


def quick_run(trainer: Trainer, args) -> None:
    batch = local_rows(synthetic_batch(args.batch, args.size, args.instances, args.seed,
                                       trainer.cfg.model.num_classes, device=trainer.device))
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        m = {k: float(v) for k, v in metrics.items()}  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        if rank() != 0:
            continue
        final = " ".join(f"{k} {v:.4f}" for k, v in m.items()
                         if k.startswith("loss_") and not k.rsplit("_", 1)[-1].isdigit())
        print(f"step {i} total_loss {m['total_loss']:.4f} {final} "
              f"grad_norm {m['grad_norm']:.4f} step_ms {ms:.1f}", flush=True)


def train_loader(cfg, args, start: int):
    """The loop's batches: `--dataset` through the config's mapper and
    `build_train_loader`, or seeded synthetic ones from step `start`."""
    if args.synthetic:
        return synthetic_loader(args.batch, args.size, args.instances, args.seed,
                                cfg.model.num_classes, start=start)
    from bm2f_tpu_torch.data import build_train_loader
    from bm2f_tpu_torch.data.mappers import MAPPERS

    name = cfg.input.dataset_mapper
    if cfg.task == "video" and "temporal_pairwise" in cfg.model.loss.sup_type:
        name = "ytvis_with_feats"
        logging.getLogger(__name__).warning(
            "the temporal pairwise loss runs on zero DINO features: the "
            "ytvis_with_feats mapper is given no features root, as in the JAX "
            "train.py, so the temporal pairs come from ties")
    mapper = MAPPERS[name](cfg.input, seed=cfg.train.seed)
    # the data axis: rank r is data rank r // mesh.model (`parallel.init_mesh`)
    model = cfg.mesh.model
    data = world_size() // model
    return build_train_loader(args.dataset, mapper, cfg.train.ims_per_batch // data,
                              seed=cfg.train.seed, rank=rank() // model, world_size=data)


def train(trainer: Trainer, args) -> int:
    """The JAX package's train.py main: resume, then the eval alone
    (`--eval-only`) or the writers and the loop. Returns the last
    iteration."""
    cfg = trainer.cfg
    ckpt = Checkpointer(os.path.join(args.output, "checkpoints"))
    start = ckpt.resume_or_load(trainer, resume=args.resume)
    say = print if rank() == 0 else (lambda *a, **k: None)
    if start is not None:
        say(f"resumed from step {start} in {ckpt.directory}", flush=True)
    if args.eval_only:
        res = dispatch_eval(cfg, trainer.eval_model(), args.eval_dataset or args.dataset)
        say("eval " + json.dumps({"iteration": trainer.step_count,
                                  **{f"eval/{k}": float(v) for k, v in res.items()}}),
            flush=True)
        return trainer.step_count
    loader = train_loader(cfg, args, trainer.step_count)
    writers = [
        ConsoleWriter(cfg.train.log_period),
        JSONWriter(os.path.join(args.output, "metrics.json"), cfg.train.log_period),
        TensorBoardWriter(os.path.join(args.output, "tb"), cfg.train.log_period),
    ]
    if args.wandb:
        writers.append(WandBWriter())
    it = run_train_loop(cfg, trainer, loader, next(loader), ckpt, EventStorage(), writers,
                        eval_dataset=args.eval_dataset,
                        profile_dir=os.path.join(args.output, "profile") if args.profile
                        else None)
    say(f"training done at iter {it}", flush=True)
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
    ap.add_argument("--dataset", default="coco_2017_train",
                    help="the registered split the loop trains on")
    ap.add_argument("--eval-dataset", default="",
                    help="evaluate this split every train.eval_period steps")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate (--eval-dataset, else --dataset) and exit")
    ap.add_argument("--data-root", default="",
                    help="where the datasets are (default $DETECTRON2_DATASETS "
                         "or ./datasets)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train the loop on seeded synthetic batches (--batch, "
                         "--size, --instances), not --dataset")
    ap.add_argument("--output", default="./output")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="trace steps 10-15 with torch.profiler into <output>/profile")
    ap.add_argument("--distributed", action="store_true",
                    help="one rank of a data-parallel run started by "
                         "`python -m torch.distributed.run`")
    ap.add_argument("--batch", type=int, default=2, help="synthetic batches")
    ap.add_argument("--size", type=int, default=1024, help="synthetic batches")
    ap.add_argument("--instances", type=int, default=8, help="synthetic batches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    looped = bool(args.max_iter or args.resume or args.eval_only)
    if looped and args.steps is not None:
        ap.error("--steps is the quick run; --max-iter, --resume and --eval-only "
                 "run the loop's set-up")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if looped:
        from bm2f_tpu_torch.data.cityscapes import register_all_cityscapes
        from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
        from bm2f_tpu_torch.data.ytvis import register_all_ytvis

        register_all_builtin_datasets(args.data_root or None, force=bool(args.data_root))
        register_all_cityscapes(args.data_root or None)
        register_all_ytvis(args.data_root or None, force=bool(args.data_root))

    cfg = get_config(args.config, dict(args.set))
    if args.max_iter:
        cfg = update(cfg, {"train.optimizer.max_iter": args.max_iter})
    device = init_distributed(args.device) if args.distributed else args.device
    try:
        global_batch = (args.batch if args.synthetic or not looped
                        else cfg.train.ims_per_batch)
        # the data axis's ranks; the trainer raises when mesh.model does not
        # divide the world
        world, model = world_size(), cfg.mesh.model
        if world % model == 0 and global_batch % (world // model):
            of = f" of the data axis (world {world}, mesh.model {model})" if model > 1 else ""
            raise ValueError(f"a global batch of {global_batch} images does not divide "
                             f"over {world // model} ranks{of}")
        trainer = Trainer(cfg, device=device, seed=args.seed)
        if looped:
            train(trainer, args)
        else:
            args.steps = 3 if args.steps is None else args.steps
            quick_run(trainer, args)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
