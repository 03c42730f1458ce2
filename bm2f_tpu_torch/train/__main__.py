"""Train step entry point of the port:

    python -m bm2f_tpu_torch.train --config coco_instance_r50 --steps 3 \\
        --batch 2 --size 1024 --instances 8 --seed 0 --device cuda

Seeded random weights and a synthetic batch in the JAX bench's recipe
(`trainer.synthetic_batch`); dataset loading is a later slice. Prints one
line per step: every loss of the final layer, total_loss, grad_norm and the
step time. `--set KEY=VALUE` overrides a config field (a Python literal),
for example a small model on the CPU:

    python -m bm2f_tpu_torch.train --device cpu --size 64 --batch 1 \\
        --instances 3 --set model.backbone.resnet.depth=14 \\
        --set model.decoder.num_queries=10
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from bm2f_tpu_torch.config import get_config, parse_override
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    # f32 as the preset sets it: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.config, dict(args.set))
    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    batch = synthetic_batch(args.batch, args.size, args.instances, args.seed,
                            cfg.model.num_classes, device=args.device)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
