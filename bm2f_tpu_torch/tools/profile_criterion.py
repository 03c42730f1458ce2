"""The set criterion and its matcher alone, value and gradient, at the
train step's shapes (the JAX package's tools/profile_criterion.py, on the
port).

    python -m bm2f_tpu_torch.tools.profile_criterion [--iters 10] [--layers 9] \\
        [--trace DIR] [--size 1024] [--device cuda]

Times `losses.criterion.set_criterion` and its gradient with respect to
the decoder's outputs, with the exact assignment on the card
(`matching.hungarian.jv_assign`, the JAX tool's `make_jv_assign_fn`), on
synthetic outputs drawn from `numpy.random.RandomState(0)` as the JAX tool
draws them: B=2, Q=100, masks at a quarter of --size (256x256), G=8
targets at --size (1024x1024), 80 classes, --layers auxiliary layers and
the final one. Every iteration draws new random points from its
generator. The step runs in the train step's scopes (f32 without TF32,
deterministic algorithms). After a warm-up, CUDA events time --iters
steps; --trace DIR writes a `torch.profiler` Chrome trace of them to
DIR/profile_criterion.pt.trace.json. Neither K1 nor K2 runs here. Runs on
the card unless --device cpu (host clock; --size cuts the shapes for a
smoke run).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

B, Q, G, K = 2, 100, 8, 80


def synthetic_inputs(size: int, layers: int, dev):
    """(outputs, targets) as the JAX tool draws them, on `dev`."""
    h = w = size // 4
    rng = np.random.RandomState(0)
    outputs = {
        "pred_logits": rng.randn(B, Q, K + 1).astype(np.float32),
        "pred_masks": rng.randn(B, Q, h, w).astype(np.float32),
        "aux_logits": rng.randn(layers, B, Q, K + 1).astype(np.float32),
        "aux_masks": rng.randn(layers, B, Q, h, w).astype(np.float32),
    }
    targets = {
        "labels": rng.randint(0, K, (B, G)).astype(np.int64),
        "masks": (rng.rand(B, G, size, size) > 0.8).astype(np.float32),
        "valid": np.ones((B, G), bool),
    }
    return ({k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in outputs.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in targets.items()})


def main(argv=None) -> dict:
    from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, set_criterion
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.matching.hungarian import make_assign_fn
    from bm2f_tpu_torch.tools.device import timed_ms, tool_device
    from bm2f_tpu_torch.utils.precision import deterministic_scope, f32_scope

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", default=None, help="torch.profiler trace directory")
    ap.add_argument("--layers", type=int, default=9, help="aux layers")
    ap.add_argument("--size", type=int, default=1024, help="target size (masks at 1/4)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (host clock)")
    args = ap.parse_args(argv)

    dev = tool_device("profile_criterion", args.device)
    outputs, targets = synthetic_inputs(args.size, args.layers, dev)
    cfg = SetCriterionConfig(num_classes=K)
    # the train step's assignment with train.matcher=jv (B*L problems at once)
    assign_fn = make_assign_fn(get_config("coco_instance_r50", {"train.matcher": "jv"}))
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = list(outputs.values())

    def step():
        points = draw_points(cfg, args.layers + 1, B, gen)
        with f32_scope("float32"), deterministic_scope():
            total, _ = set_criterion(outputs, targets, cfg, points, assign_fn=assign_fn)
            grads = torch.autograd.grad(total, leaves)
        return total, grads

    t0 = time.perf_counter()
    total, grads = step()
    loss = total.item()
    print(f"first step {time.perf_counter() - t0:.1f}s loss={loss:.4f}", flush=True)
    if not (np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise RuntimeError(f"profile_criterion: a non-finite loss or gradient ({loss})")

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            ms = timed_ms(step, args.iters, dev=dev)
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "profile_criterion.pt.trace.json"))
    else:
        ms = timed_ms(step, args.iters, dev=dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, cpu"
    print(f"criterion fwd+bwd: {ms:.1f} ms/step over {args.iters} iters ({clock})",
          flush=True)
    return {"loss": loss, "ms": ms}


if __name__ == "__main__":
    main()
