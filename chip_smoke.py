#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`bm2f_tpu_torch`) on one NVIDIA
GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its own line:
  1. device: name, and name + power limit as nvidia-smi reports them;
  2. build every hand-written kernel from bm2f_tpu_torch/csrc/ (one nvcc per
     source, all started together);
  3. each kernel against its plain PyTorch version on the card: edge cases
     and the main-path shapes;
  4. kernel timing (CUDA events, the wrapper calls) beside the plain
     version and the bound;
  5. the main path: `Predictor` on `coco_instance_r50` at full width with
     seeded random weights answers 3 requests; every kernel's launch count
     is set to 0 just before and read just after;
  6. forward parity on the card: kernel path against the plain path;
  7. K2 (the deformable-attention backward) against its plain version on
     the card: edge cases and the train-path shapes, each run twice (d_loc
     and d_attn bitwise equal, d_value within the atomics' tolerance);
  8. K2 and K1 timing (the wrapper calls) at the train-path shapes beside
     the plain versions and the bound;
  9. gradient parity on the card: `Trainer` on `coco_instance_r50` at full
     width, at its seeded init, one B=1 1024x1024 step's loss and
     gradients through the kernels against the plain path, on the same
     random points, taken apart into K2's share and the forward's (see
     `grad_parity`), and K2 against an f64 backward layer by layer;
 10. the train path: that trainer's step at B=2, 1024x1024, one warm-up
     step and 3 timed steps with every kernel's launch count set to 0 just
     before and read just after; finite losses, nonzero gradients of every
     encoder layer's deformable projections, the step's time split by
     stage and peak memory;
 11. phase 9 again at the trained state;
 12. the gather probe (`python -m bm2f_tpu_torch.tools.roofline_microbench`,
     driven through its `bench_level`): K3 and K4 in f32 and bf16 at the
     production shapes (BM 32, QP 13312, K 4), S 625, 2500 and 10000,
     random and coherent addresses, every count set to 0 just before and
     read just after. Each output bitwise equal to the plain version; each
     timed beside the plain version, the bound and `F.embedding_bag`, K4
     beside both of its tensor-core ceilings (dense, and the products it
     issues);
 13. K1 on a bf16 `value` against its plain version (edge cases and the
     800x800 shapes at B=1 and 4) and timed (the wrapper calls) beside it
     and its bound;
 14. bf16 serving: `Predictor` with model.dtype=bfloat16 and
     pixel_decoder_f32=False (the JAX bench's configuration) answers the 3
     requests with every count set to 0 before and read after (K1-bf16 6
     launches a request, K1-f32 none); its stage split; parity of
     pred_logits and pred_masks against the plain path in bf16 and against
     the f32 kernel path on the same weights; then one request with
     pixel_decoder_f32=True, where K1-f32 launches 6 times;
 15. K2 on a bf16 `value` against its plain version (which upcasts, computes
     in f32 and rounds d_value to bf16 once) on the card: edge cases and the
     train-path shapes, each run twice (d_loc and d_attn bitwise equal,
     d_value within a tolerance scaled by its largest element), then timed
     (the wrapper calls) beside the plain version and the bound;
 16. the bf16 train path: `Trainer` on `coco_instance_r50` at full width in
     the JAX train bench's configuration (model.dtype=bfloat16,
     pixel_decoder_f32=False, train.matcher=jv), B=2, 1024x1024, 8 targets:
     one warm-up step and 3 timed steps with every count set to 0 just
     before and read just after (K1-bf16 and K2-bf16 6 launches a step,
     K1-f32 and K2-f32 none); finite losses, nonzero gradients of every
     encoder layer's deformable projections, the split by stage and peak
     memory; then the loss and every gradient through the kernels against
     the plain path in bf16 on the same random points, norm-relative;
 17. the matcher on the card: `jv_assign` on the device against the host
     LAP on the cost matrices of the warm-up step of phase 16 (the same
     query for every valid target, the same total cost), both timed;
 18. checkpoint and resume: phase 16's trainer saved, a fresh trainer
     resumed from it (`Checkpointer.resume_or_load`), its whole state
     bitwise equal; one more step from each, the losses equal and the
     gradient norms within K2's atomics tolerance;
 19. one JSON line {"kernels": [...]}, then the nvidia-smi line, then the
     result line {"ok": true, "device": {...}} last.

Any failure raises and the script exits non-zero. It imports nothing of JAX
or of the JAX package. TF32 is off for matmuls and convolutions throughout.
The kernels build in phase 2 with the native LAP solver (`csrc/lap.cpp`,
the host compiler) beside them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, f32 outside the
# tensor cores (the probe's bounds, with the tensor cores' rates, are
# computed by bm2f_tpu_torch/tools/roofline_microbench.py)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# main-path shapes of the deformable-attention kernel: coco_instance_r50 at
# 800x800 -> levels 25x25, 50x50, 100x100 (strides 32, 16, 8)
MAIN_SHAPES = ((25, 25), (50, 50), (100, 100))
M, D, P = 8, 32, 4
REQUESTS = ((800, 800), (480, 640), (800, 1088))
# the train path: LSJ crops of 1024x1024 (levels 32x32, 64x64, 128x128),
# the per-GPU share of the reference's 16-image batch, 8 targets per image
CONFIG = "coco_instance_r50"
TRAIN_SIZE, TRAIN_BATCH, TRAIN_INSTANCES, TRAIN_STEPS = 1024, 2, 8, 3
TRAIN_SHAPES = tuple((TRAIN_SIZE // s, TRAIN_SIZE // s) for s in (32, 16, 8))
# K2's tolerances against its plain version (tests/test_ops.py:176-178)
GRAD_TOL = {"d_value": dict(rtol=1e-4, atol=1e-5),
            "d_loc": dict(rtol=1e-3, atol=1e-4),
            "d_attn": dict(rtol=1e-4, atol=1e-5)}
# d_value between two runs of K2: its atomic sums (up to ~1e3 terms a pixel
# at the edge cases) run in another order each time, so an element may move
# by a few f32 ulps of the largest sum: rtol 1e-5, atol 1e-6 x max |d_value|
REPEAT_RTOL, REPEAT_ATOL_OF_MAX = 1e-5, 1e-6
# every parameter's gradient, norm-relative, through K1 + K2 against K1 + the
# closed-form plain backward (grad_parity's A-C), and through the closed form
# against autograd (D-B): both read 5e-7 at the init and 1.4e-6 after the
# train steps, as K2 against itself does (PERF.md)
SAME_FORWARD_REL = 1e-5
# bf16 serving at 800x800, norm-relative, on pred_logits and pred_masks:
# through K1-bf16 against the plain path in bf16, and against the f32 kernel
# path on the same weights. Read on an H100: 7.4e-3 to 2.0e-2 both ways (the
# two bf16 paths round K1's f32 sums differently, and the predictor's mask
# threshold turns that into flipped mask bits); held at 2.5x the largest
BF16_VS_PLAIN_REL = BF16_VS_F32_REL = 0.05
# bf16 serving: the bench's configuration, and with the pixel decoder in f32
BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}
BF16_PD_F32 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": True}
# the bf16 train path: the JAX train bench's configuration (bench.py:315-322)
TRAIN_BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False,
              "train.matcher": "jv"}
# K2 on a bf16 value against the plain bf16 backward: both round an f32 sum
# of d_value to bf16 once, the sums in another order, so an element may
# round to the neighbouring bf16 (2^-8 of it) or move by the f32 noise of
# the largest sum (as tests/test_torch_cuda.py)
BF16_D_VALUE_RTOL, BF16_D_VALUE_ATOL_OF_MAX = 2.0 ** -7, 1e-5
# the bf16 step, the loss and all gradients (norm-relative, every parameter
# at once) through K1-bf16 + K2-bf16 against autograd of the plain path in
# bf16, on the same weights, batch and random points. Read on an H100 in two
# runs: loss 7.9e-4 and 6.2e-4, gradients 5.0e-2 and 5.7e-2 (backbone 0.10,
# 0.12): the two paths round K1's f32 sums differently before the bf16
# output projection, and bf16 carries that through the network as it
# carries its own rounding (JAX's bf16 gradients sit 0.13 from its f32 ones,
# tests/test_torch_train_bf16.py); held at 2.5x the largest readings. K2-bf16
# itself is held sharply in phase 15
BF16_TRAIN_LOSS_REL, BF16_TRAIN_GRAD_REL = 2e-3, 0.15
# a resumed trainer's step against the saved trainer's: the forward is the
# same computation (losses equal to f32 rounding); the gradient norm goes
# through K2's atomics and cuDNN's backward. Read on an H100: losses equal,
# gradient norm 6.4e-6
RESUME_LOSS_RTOL, RESUME_GRAD_NORM_RTOL = 1e-6, 1e-4
# the probe: level sizes of every impl; CUDA-event launches
PROBE_LEVELS, PROBE_ITERS = (625, 2500, 10000), 20
# the probe's row of each kernel in the kernels line
PROBE_ROW = dict(S=2500, addresses="random")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def deform_inputs(B, shapes, Q, gen, dev, loc_range=None):
    """value, locations, attention weights from a seeded generator: uniform
    in `loc_range`, or around the encoder's reference points (the
    deformable-attention bench's inputs)."""
    from bm2f_tpu_torch.tools.deform_attn_bench import deform_inputs as inputs

    return inputs(B, shapes, Q, gen, dev, loc_range)


def n_tiles(shapes, Q, cells) -> int:
    """The tiles of queries K1 (cells=False) or K2 (cells=True) takes at
    these shapes (a block each per (b, m))."""
    from bm2f_tpu_torch.ops.deform_attn import tile_plan

    return len(tile_plan(shapes, Q, cells).tile_ptr) - 1


def valid_corners(shapes, loc) -> int:
    """Bilinear corners inside their level, over all samples of `loc`: the
    work the kernels do for this data (a corner outside is skipped)."""
    n = 0
    for lid, (H, W) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lid, :, 0] * W - 0.5)
        y0 = torch.floor(loc[:, :, :, lid, :, 1] * H - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                n += int(((x0 + dx >= 0) & (x0 + dx < W) & (y0 + dy >= 0)
                          & (y0 + dy < H)).sum())
    return n


def bound_ms(n_bytes: int, flops: int):
    """(least time in ms, what bounds it): bytes over the HBM rate against
    operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def deform_bound_ms(B, shapes, Q, L, loc, value_bytes=4):
    """K1: reads value (`value_bytes` an element), loc, attn once and writes
    the f32 output once; one FMA per valid corner and channel."""
    S = sum(h * w for h, w in shapes)
    n_bytes = (value_bytes * B * S * M * D
               + 4 * (B * Q * M * L * P * 2 + B * Q * M * L * P + B * Q * M * D))
    flops = 2 * D * valid_corners(shapes, loc)
    return (*bound_ms(n_bytes, flops), n_bytes, flops)


def deform_bwd_bound_ms(B, shapes, Q, L, loc, value_bytes=4):
    """K2: reads value, loc, attn and grad_out once and writes d_value,
    d_loc and d_attn once (value and d_value `value_bytes` an element, the
    rest f32); per valid corner and channel one FMA for the dot product and
    a multiply and an add into d_value."""
    S = sum(h * w for h, w in shapes)
    n_bytes = value_bytes * 2 * B * S * M * D \
        + 4 * 2 * (B * Q * M * L * P * 2 + B * Q * M * L * P) + 4 * B * Q * M * D
    flops = 4 * D * valid_corners(shapes, loc)
    return (*bound_ms(n_bytes, flops), n_bytes, flops)


def grid_sample_composite(value, shapes, loc, attn):
    """Per-level `F.grid_sample` composite of the same function — a
    yardstick only; the port never calls it."""
    import torch.nn.functional as F

    B, S, M_, D_ = value.shape
    Q, L = loc.shape[1], len(shapes)
    out = torch.zeros(B, M_, D_, Q, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 3, 1).reshape(B * M_, D_, H, W)
        start += H * W
        g = (loc[:, :, :, lid] * 2 - 1).permute(0, 2, 1, 3, 4).reshape(B * M_, Q, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False).reshape(B, M_, D_, Q, P)
        out += (s * attn[:, :, :, lid].permute(0, 2, 1, 3)[:, :, None]).sum(-1)
    return out.permute(0, 3, 1, 2).reshape(B, Q, M_ * D_)


def check_k2(dev, gen):
    """Phase 7: K2 against the closed-form plain backward on K1's edge cases
    and the train-path shapes, twice each. Returns (max abs error over the
    three gradients at the train shapes, the train-shape inputs)."""
    from bm2f_tpu_torch.ops.deform_attn import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_bwd_plain,
    )

    S_train = sum(h * w for h, w in TRAIN_SHAPES)
    cases = [
        (2, ((1, 7), (5, 1), (4, 6)), 777, (-0.2, 1.2)),
        (1, ((1, 1), (3, 9)), 1001, (-0.2, 1.2)),
        (TRAIN_BATCH, TRAIN_SHAPES, S_train, None),
    ]
    for B, shapes, Q, rng in cases:
        v, loc, attn = deform_inputs(B, shapes, Q, gen, dev, rng)
        g = torch.randn(B, Q, M * D, generator=gen).to(dev)
        first = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        second = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        torch.cuda.synchronize()
        want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
        errs = {}
        for name, a, b, w in zip(GRAD_TOL, first, second, want):
            torch.testing.assert_close(a, w, msg=name, **GRAD_TOL[name])
            errs[name] = (a - w).abs().max().item()
            if name == "d_value":
                torch.testing.assert_close(
                    a, b, rtol=REPEAT_RTOL, atol=REPEAT_ATOL_OF_MAX * w.abs().max().item())
                errs["d_value_repeat"] = (a - b).abs().max().item()
            elif not torch.equal(a, b):
                raise AssertionError(f"{name} differs between two runs of K2")
        log("check_bwd", case="edge" if rng else "train", B=B, shapes=shapes, Q=Q,
            **{f"{k}_max_abs_err": f"{e:.3e}" for k, e in errs.items()})
    return max(errs[k] for k in GRAD_TOL), (v, loc, attn, g)


def time_k2(inputs):
    """Phase 8: K2 and K1 at the train-path shapes (CUDA events, warm), the
    plain versions, the bound, and autograd of the grid_sample composite
    as a yardstick only."""
    from bm2f_tpu_torch.ops.deform_attn import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_bwd_plain,
        ms_deform_attn_cuda,
        ms_deform_attn_plain,
    )

    v, loc, attn, g = inputs
    B, Q, L = v.shape[0], loc.shape[1], len(TRAIN_SHAPES)
    k_ms = cuda_ms(lambda: ms_deform_attn_bwd_cuda(v, TRAIN_SHAPES, loc, attn, g), 20)
    p_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(v, TRAIN_SHAPES, loc, attn, g), 3)
    leaves = [t.clone().requires_grad_(True) for t in (v, loc, attn)]
    out = grid_sample_composite(leaves[0], TRAIN_SHAPES, leaves[1], leaves[2])
    gs_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 3)
    del out, leaves
    bound, by, n_bytes, flops = deform_bwd_bound_ms(B, TRAIN_SHAPES, Q, L, loc)
    log("time", kernel="ms_deform_attn_bwd", B=B, tiles=n_tiles(TRAIN_SHAPES, Q, True),
        ms=f"{k_ms:.4f}",
        plain_ms=f"{p_ms:.4f}", grid_sample_composite_bwd_ms=f"{gs_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes, flops=flops,
        zeroing_bytes=4 * v.numel(), share_of_bound=f"{bound / k_ms:.3f}")
    f_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, TRAIN_SHAPES, loc, attn), 20)
    fp_ms = cuda_ms(lambda: ms_deform_attn_plain(v, TRAIN_SHAPES, loc, attn), 3)
    f_bound, f_by, f_bytes, f_flops = deform_bound_ms(B, TRAIN_SHAPES, Q, L, loc)
    log("time", kernel="ms_deform_attn_fwd", B=B, shapes="train",
        tiles=n_tiles(TRAIN_SHAPES, Q, False), ms=f"{f_ms:.4f}",
        plain_ms=f"{fp_ms:.4f}", bound_ms=f"{f_bound:.4f}", bound_by=f_by,
        bytes=f_bytes, flops=f_flops, share_of_bound=f"{f_bound / f_ms:.3f}")
    return k_ms, p_ms, bound, by


def reset_counts():
    """Every kernel wrapper's launch counts to 0."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.ops.gather_probe import (
        row_gather_sum_cuda,
        row_gather_sum_onehot_cuda,
    )

    for fn in (ms_deform_attn_cuda, ms_deform_attn_bwd_cuda, row_gather_sum_cuda,
               row_gather_sum_onehot_cuda):
        fn.launches = fn.launches_bf16 = 0


def serve(pred, images, path: str) -> list:
    """`pred` answers `images`, each request ending in a synchronise; checks
    the outputs' shapes and values. Returns the latencies in ms."""
    latencies = []
    for img in images:
        t0 = time.perf_counter()
        out = pred.predict(img)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        H, W = img.shape[:2]
        K = pred.cfg.model.num_classes
        if (out["semantic"].shape != (H, W, K) or out["semantic"].dtype != np.float32
                or not np.isfinite(out["semantic"]).all()):
            raise AssertionError(f"semantic output {out['semantic'].shape} bad")
        inst = out["instances"]
        if inst["masks"].shape != (100, H, W) or not np.isfinite(inst["scores"]).all():
            raise AssertionError(f"instance output {inst['masks'].shape} bad")
        if out["panoptic"][0].shape != (H, W):
            raise AssertionError("panoptic output shape bad")
    for img, ms in zip(images, latencies):
        log("request", path=path, size="x".join(map(str, img.shape[:2])),
            latency_ms=f"{ms:.2f}")
    return latencies


def stage_split(pred, image, path: str):
    """The network's stages on one request, synchronised between stages.
    Returns the unnormalised input batch."""
    from bm2f_tpu_torch.models.maskformer import normalize_images

    model, dev = pred.model, pred.device
    x = torch.zeros((1, *image.shape))
    x[0] = torch.from_numpy(image.astype(np.float32))
    stages = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        xin = normalize_images(x.to(dev), pred.cfg.model).permute(0, 3, 1, 2).contiguous()
        feats = model.backbone(xin)
        torch.cuda.synchronize()
        stages["backbone"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        mf, _, ms_feats = model.sem_seg_head.pixel_decoder(feats)
        torch.cuda.synchronize()
        stages["pixel_decoder"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        model.sem_seg_head.predictor(ms_feats, mf)
        torch.cuda.synchronize()
        stages["predictor"] = (time.perf_counter() - t) * 1e3
    log("stages", path=path, **{k: f"{v:.2f}ms" for k, v in stages.items()})
    return x


def make_trainer(dev):
    """The full-width trainer at its seeded init, with the deformable
    projections perturbed (general sampling locations, not a grid)."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config(CONFIG), device=dev, seed=0)
    perturb_deformable(trainer.model)
    return trainer


def train_path(trainer, dev):
    """Phase 10: the trainer's step at full width. Returns the launch counts
    of K1 and K2 over the timed steps."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.train.trainer import StageTimer, synthetic_batch

    t0 = time.perf_counter()
    batch = synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=0,
                            device=dev)
    trainer.step(batch)  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    log("train_setup", config=CONFIG, batch=TRAIN_BATCH, size=TRAIN_SIZE,
        instances=TRAIN_INSTANCES, seconds=f"{time.perf_counter() - t0:.2f}")
    torch.cuda.reset_peak_memory_stats()

    timer = StageTimer(dev)
    reset_counts()
    step_ms = []
    for i in range(TRAIN_STEPS):
        timer.start()
        t = time.perf_counter()
        metrics = {k: v.item() for k, v in trainer.step(batch, mark=timer).items()}
        step_ms.append((time.perf_counter() - t) * 1e3)
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite {bad}")
        log("train_step", step=i, total_loss=f"{metrics['total_loss']:.4f}",
            loss_ce=f"{metrics['loss_ce']:.4f}", loss_mask=f"{metrics['loss_mask']:.4f}",
            loss_dice=f"{metrics['loss_dice']:.4f}",
            grad_norm=f"{metrics['grad_norm']:.4f}", step_ms=f"{step_ms[-1]:.2f}")
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches)
    bf16_launches = (ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
    n_layers = len(trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers)
    if launches != (n_layers * TRAIN_STEPS,) * 2 or bf16_launches != (0, 0):
        raise AssertionError(f"K1, K2 launched {launches} times in {TRAIN_STEPS} "
                             f"steps, expected {n_layers * TRAIN_STEPS} each, and "
                             f"on a bf16 value {bf16_launches}, expected none")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the gradient reaches every deformable projection through K2
    grads = {}
    for i, layer in enumerate(trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers):
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            w = getattr(layer.self_attn, name).weight.grad
            grads[f"{i}.{name}"] = 0.0 if w is None else w.abs().sum().item()
    zero = [k for k, v in grads.items() if not v > 0]
    if zero:
        raise AssertionError(f"no gradient reached encoder projections {zero}")
    log("train_grads", min_abs_sum=f"{min(grads.values()):.3e}",
        **{k.replace(".", "_"): f"{v:.3e}" for k, v in grads.items() if k.startswith("0.")})
    log("train_main", k1_launches=launches[0], k2_launches=launches[1],
        step_ms_mean=f"{sum(step_ms) / len(step_ms):.2f}",
        peak_mem_gib=f"{peak:.2f}")
    log("train_stages", **{k: f"{v / TRAIN_STEPS:.2f}ms" for k, v in timer.ms.items()})
    return launches


def rel_err(a, b) -> float:
    """|a - b| / |b| (Frobenius norms, in f64)."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-300)).item()


def _watch(module, name, store, keep):
    """Patch `module.name` with a wrapper that appends keep(args, out) to
    `store` on every call. The wrapper carries the original's attributes: a
    kernel wrapper counts its launches on whatever its global name holds."""
    orig = getattr(module, name)

    @functools.wraps(orig)
    def wrapper(*args):
        out = orig(*args)
        store.append(keep(args, out))
        return out

    return mock.patch.object(module, name, wrapper)


def _grad_path(trainer, batch, points, params, impl="auto", fwd=None, bwd=None,
               k2_calls=None):
    """One loss and every parameter's gradient. `fwd` / `bwd` stand in for
    K1 / K2 inside MSDeformAttnFunction; impl="plain" is autograd of the
    plain forward. Also returns what the path computed on the way: each
    encoder layer's (shapes, locations), the importance selections and the
    assignments; K2's (inputs, outputs) go to `k2_calls` when given."""
    from bm2f_tpu_torch.losses import criterion
    from bm2f_tpu_torch.models import pixel_decoder
    from bm2f_tpu_torch.ops import deform_attn

    locs, sel, asg = [], [], []
    with contextlib.ExitStack() as stack:
        if fwd is not None:
            stack.enter_context(mock.patch.object(deform_attn, "ms_deform_attn_cuda", fwd))
        if bwd is not None:
            stack.enter_context(mock.patch.object(deform_attn, "ms_deform_attn_bwd_cuda", bwd))
        for name in ("ms_deform_attn", "ms_deform_attn_plain"):
            stack.enter_context(_watch(pixel_decoder, name, locs,
                                       lambda a, o: (a[1], a[2].detach())))
        stack.enter_context(_watch(criterion, "_importance_weights", sel, lambda a, o: o))
        stack.enter_context(_watch(trainer, "assign_fn", asg, lambda a, o: o))
        if k2_calls is not None:
            stack.enter_context(_watch(deform_attn, "ms_deform_attn_bwd_cuda", k2_calls,
                                       lambda a, o: (a, o)))
        total, _ = trainer.loss(batch, points, deform_impl=impl)
        grads = torch.autograd.grad(total, params)
    return total.item(), grads, locs, sel, asg


def corner_moves(shapes, loc_a, loc_b) -> int:
    """Samples whose top-left corner pixel differs between two location
    tensors of one layer (the arithmetic of the kernels' corners)."""
    n = 0
    for lid, (H, W) in enumerate(shapes):
        size = loc_a.new_tensor([W, H])
        fa = torch.floor(loc_a[:, :, :, lid] * size - 0.5)
        fb = torch.floor(loc_b[:, :, :, lid] * size - 0.5)
        n += int((fa != fb).any(-1).sum())
    return n


def offsets_grad(d_loc, shapes, x):
    """The sampling-offset weight gradient a d_loc gives, in f64: loc =
    reference + offsets / (W, H) per level, and offsets = x @ weight.T."""
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float64,
                        device=d_loc.device)
    d_off = d_loc.double() / norm[:, None, :]
    n = x.shape[0] * x.shape[1]
    return d_off.reshape(n, -1).T @ x.reshape(n, -1).double()


def k2_against_f64(k2_calls, offsets_in):
    """On each encoder layer's own inputs, as the kernel path handed them to
    K2: d_loc and the sampling-offset weight gradient from K2 and from the
    plain backward in f32, against the plain backward in f64 (locations
    kept f32, so all three use the same corners and fractions)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_plain

    rows = []
    # the backward runs the layers last to first
    for ((v, shapes, loc, attn, g), (_, dl_k, _)), x in zip(k2_calls[::-1], offsets_in):
        dl_p = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)[1]
        dl_r = ms_deform_attn_bwd_plain(v.double(), shapes, loc, attn.double(),
                                        g.double())[1]
        dw_k, dw_p, dw_r = (offsets_grad(d, shapes, x) for d in (dl_k, dl_p, dl_r))
        rows.append({"dloc_k2": rel_err(dl_k, dl_r), "dloc_plain": rel_err(dl_p, dl_r),
                     "dw_k2": rel_err(dw_k, dw_r), "dw_plain": rel_err(dw_p, dw_r),
                     "dw_k2_vs_plain": rel_err(dw_k, dw_p)})
    return rows


def grad_parity(trainer, dev, state: str):
    """Phases 9 and 11: one B=1 1024x1024 loss and every parameter's
    gradient on the same weights, batch and random points, five ways:
      A  K1 forward, K2 backward (the train path); A2 the same again
      C  K1 forward, the closed-form plain backward
      D  the plain forward, the closed-form plain backward
      B  autograd of the plain forward (deform_impl="plain")
    A-A2 is K2's atomics noise, A-C K2's arithmetic inside the model, C-D the
    forward (K1 against the plain einsum), D-B the closed form against
    autograd, A-B the whole. Also counts the samples whose corners moved
    between A's and D's forward, the importance selections and assignments
    that differ, and holds K2 against an f64 backward layer by layer."""
    from bm2f_tpu_torch.losses.criterion import draw_points
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_plain, ms_deform_attn_plain
    from bm2f_tpu_torch.train.trainer import synthetic_batch

    batch = synthetic_batch(1, TRAIN_SIZE, TRAIN_INSTANCES, seed=1, device=dev)
    n_layers = trainer.cfg.model.decoder.dec_layers + 1
    points = draw_points(trainer.ccfg, n_layers, 1,
                         torch.Generator(device=dev).manual_seed(5))
    names, params = zip(*trainer.model.named_parameters())
    layers = trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers

    offsets_in, k2_calls = [], []
    hooks = [layer.self_attn.sampling_offsets.register_forward_hook(
        lambda mod, inp, out: offsets_in.append(inp[0].detach())) for layer in layers]
    try:
        run = {"A": _grad_path(trainer, batch, points, params, k2_calls=k2_calls)}
    finally:
        for h in hooks:
            h.remove()
    run["A2"] = _grad_path(trainer, batch, points, params)
    run["C"] = _grad_path(trainer, batch, points, params, bwd=ms_deform_attn_bwd_plain)
    run["D"] = _grad_path(trainer, batch, points, params, fwd=ms_deform_attn_plain,
                          bwd=ms_deform_attn_bwd_plain)
    run["B"] = _grad_path(trainer, batch, points, params, impl="plain")

    worst = {}
    for pair in ("A-A2", "A-C", "C-D", "D-B", "A-B"):
        ga, gb = run[pair.split("-")[0]][1], run[pair.split("-")[1]][1]
        rel = [rel_err(a, b) for a, b in zip(ga, gb)]
        i = max(range(len(rel)), key=rel.__getitem__)
        worst[pair] = (rel[i], names[i], rel)
    moves = [corner_moves(sa, la, lb) for (sa, la), (_, lb) in zip(run["A"][2], run["D"][2])]
    sel_diff = sum(int((a != b).sum()) for a, b in zip(run["A"][3], run["B"][3]))
    asg_diff = sum(int((a != b).sum()) for a, b in zip(run["A"][4], run["B"][4]))
    loss_a, loss_b = run["A"][0], run["B"][0]
    log("grad_parity", state=state, loss_kernel=f"{loss_a:.6f}", loss_plain=f"{loss_b:.6f}",
        params=len(names),
        **{f"{p}_worst": f"{w[0]:.3e}@{w[1]}" for p, w in worst.items()})
    samples = run["A"][2][0][1][..., 0].numel()
    log("grad_parity_cause", state=state, samples_per_layer=samples,
        corner_moves_by_layer=moves, importance_points_differing=sel_diff,
        assignments_differing=asg_diff)
    for i, row in enumerate(k2_against_f64(k2_calls, offsets_in)):
        log("k2_vs_f64", state=state, layer=i, **{k: f"{v:.3e}" for k, v in row.items()})
        if not row["dloc_k2"] <= 2 * row["dloc_plain"]:
            raise AssertionError(f"layer {i}: K2's d_loc departs from f64 more than "
                                 f"the plain f32 backward's: {row}")
    if not abs(loss_a - loss_b) <= 1e-4 * abs(loss_b):
        raise AssertionError(f"loss through the kernels {loss_a} vs plain {loss_b}")
    for pair in ("A-C", "D-B"):
        if not worst[pair][0] <= SAME_FORWARD_REL:
            raise AssertionError(f"{pair}: backwards on the same forward differ by "
                                 f"{worst[pair][:2]}")
    # the forwards differ in f32 rounding, which moves a few samples across
    # a pixel-centre line (where the bilinear derivative jumps) and may swap
    # an importance point: the kernel-vs-plain gap, bounded at the init
    if state == "init":
        for name, r in zip(names, worst["A-B"][2]):
            if not r <= 1e-3:
                raise AssertionError(f"{name}: |g_kernel - g_plain| / |g_plain| = {r}")


def probe_path():
    """Phase 12: the gather probe's main path at the production shapes, with
    every count set to 0 just before and read just after. Each launch is the
    probe's own: one checked bitwise against the plain version (the probe
    raises on a difference), warm-up and timed ones. Returns (the probe's
    lines, {kernel: launches})."""
    from bm2f_tpu_torch.ops.gather_probe import (
        row_gather_sum_cuda,
        row_gather_sum_onehot_cuda,
    )
    from bm2f_tpu_torch.tools import roofline_microbench as probe

    t0 = time.perf_counter()
    runs = [(S, c, probe.IMPLS) for S in PROBE_LEVELS for c in (False, True)]
    reset_counts()
    lines = []
    for S, coherent, impls in runs:
        lines += probe.bench_level(S, PROBE_ITERS, coherent=coherent, impls=impls)
    counts = {"gather_rows_f32": row_gather_sum_cuda.launches,
              "gather_rows_bf16": row_gather_sum_cuda.launches_bf16,
              "gather_onehot_f32": row_gather_sum_onehot_cuda.launches,
              "gather_onehot_bf16": row_gather_sum_onehot_cuda.launches_bf16}
    per_call = 1 + 3 + PROBE_ITERS  # checked, warm-up, timed
    impl_of = {"gather_rows_f32": "scalar", "gather_rows_bf16": "scalar_bf16",
               "gather_onehot_f32": "onehot", "gather_onehot_bf16": "onehot_bf16"}
    for name, impl in impl_of.items():
        want = per_call * sum(impl in impls for _, _, impls in runs)
        if counts[name] != want:
            raise AssertionError(f"{name} launched {counts[name]} times, expected {want}")
    if not all(ln["bitwise_equal"] and ln["max_err_vs_plain"] == 0.0 for ln in lines):
        raise AssertionError("a probe kernel differs from the plain version")
    log("probe", lines=len(lines), seconds=f"{time.perf_counter() - t0:.2f}",
        **{f"{k}_launches": v for k, v in counts.items()})
    return lines, counts


def check_k1_bf16(dev, gen):
    """Phase 13: K1 on a bf16 `value` against its plain version (which
    upcasts `value` and computes in f32) on K1's edge cases and the 800x800
    shapes at B=1 and 4, then timed at those shapes beside the plain version
    and the bound. Returns (max abs error and timing at B=1)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain

    S_main = sum(h * w for h, w in MAIN_SHAPES)
    cases = [(2, ((1, 7), (5, 1), (4, 6)), 777, (-0.2, 1.2)),
             (1, ((1, 1), (3, 9)), 1001, (-0.2, 1.2)),
             (1, MAIN_SHAPES, S_main, None), (4, MAIN_SHAPES, S_main, None)]
    errs, timing = {}, {}
    for B, shapes, Q, rng in cases:
        v, loc, attn = deform_inputs(B, shapes, Q, gen, dev, rng)
        v = v.to(torch.bfloat16)
        got = ms_deform_attn_cuda(v, shapes, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(v, shapes, loc, attn)
        # f32 arithmetic on the same bf16 rows, sums in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        log("check", kernel="ms_deform_attn_fwd_bf16", case="edge" if rng else "main",
            B=B, Q=Q, max_abs_err=f"{err:.3e}")
        if rng is None:
            errs[B] = err
            k_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, shapes, loc, attn), 50)
            p_ms = cuda_ms(lambda: ms_deform_attn_plain(v, shapes, loc, attn), 10)
            bound, by, n_bytes, flops = deform_bound_ms(B, shapes, Q, 3, loc, value_bytes=2)
            timing[B] = (k_ms, p_ms, bound, by)
            log("time", kernel="ms_deform_attn_fwd_bf16", B=B, tiles=n_tiles(shapes, Q, False),
                ms=f"{k_ms:.4f}",
                plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
                bytes=n_bytes, flops=flops, share_of_bound=f"{bound / k_ms:.3f}")
    return errs[1], timing[1]


def serve_bf16(dev, images):
    """Phase 14: bf16 serving. Returns {path: (K1-f32, K1-bf16) launches}."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models import build_model
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    pred = Predictor()
    pred.setup(CONFIG, device="cuda", seed=0, overrides=BF16)
    perturb_deformable(pred.model)  # the weights of phase 5
    pred.predict(images[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    serve(pred, images, "bf16")
    launches = {"bf16": (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)}
    if launches["bf16"] != (0, 6 * len(images)) or ms_deform_attn_bwd_cuda.launches:
        raise AssertionError(f"bf16 serving launched K1 f32, bf16 {launches['bf16']} "
                             f"times and K2 {ms_deform_attn_bwd_cuda.launches}, expected "
                             f"0, {6 * len(images)} and 0")
    log("main_bf16", k1_f32_launches=launches["bf16"][0],
        k1_bf16_launches=launches["bf16"][1],
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    x = stage_split(pred, images[0], "bf16")

    # parity: the plain path in bf16, and the f32 kernel path on the same f32
    # weights (drawn again from the seeds: the Predictor's are cast to bf16)
    f32 = build_model(get_config(CONFIG), device=dev, seed=0)
    perturb_deformable(f32)
    with torch.no_grad():
        xn = normalize_images(x.to(dev), pred.cfg.model)
        outs = {"kernel": pred.model(xn), "plain": pred.model(xn, deform_impl="plain"),
                "f32": f32(xn)}
    del f32
    for key in ("pred_logits", "pred_masks"):
        a = outs["kernel"][key]
        if a.dtype != torch.float32 or not torch.isfinite(a).all():
            raise AssertionError(f"bf16 {key}: {a.dtype}, finite {torch.isfinite(a).all()}")
        r_plain, r_f32 = rel_err(a, outs["plain"][key]), rel_err(a, outs["f32"][key])
        log("parity_bf16", key=key, vs_plain_bf16=f"{r_plain:.3e}",
            vs_f32_kernel=f"{r_f32:.3e}",
            max_abs_vs_plain_bf16=f"{(a - outs['plain'][key]).abs().max().item():.3e}",
            max_abs_vs_f32=f"{(a - outs['f32'][key]).abs().max().item():.3e}")
        if not (r_plain <= BF16_VS_PLAIN_REL and r_f32 <= BF16_VS_F32_REL):
            raise AssertionError(f"bf16 {key}: {r_plain:.3e} from the plain path "
                                 f"(limit {BF16_VS_PLAIN_REL}), {r_f32:.3e} from f32 "
                                 f"(limit {BF16_VS_F32_REL})")
    del outs

    # one request with the pixel decoder in f32: K1 reads an f32 value
    del pred
    pred = Predictor()
    pred.setup(CONFIG, device="cuda", seed=0, overrides=BF16_PD_F32)
    perturb_deformable(pred.model)
    pred.predict(images[0])  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    serve(pred, images[:1], "bf16_pixel_decoder_f32")
    launches["bf16_pd_f32"] = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    if launches["bf16_pd_f32"] != (6, 0):
        raise AssertionError(f"pixel_decoder_f32 launched K1 f32, bf16 "
                             f"{launches['bf16_pd_f32']} times, expected 6, 0")
    log("main_bf16_pd_f32", k1_f32_launches=launches["bf16_pd_f32"][0],
        k1_bf16_launches=launches["bf16_pd_f32"][1])
    return launches


def check_k2_bf16(dev, gen):
    """Phase 15: K2 on a bf16 `value` against the plain bf16 backward on
    K1's edge cases and the train-path shapes, twice each, then timed at the
    train shapes beside the plain version and the bound. Returns (max abs
    error over the three gradients at the train shapes, (ms, plain ms,
    bound ms, bound_by))."""
    from bm2f_tpu_torch.ops.deform_attn import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_bwd_plain,
    )

    S_train = sum(h * w for h, w in TRAIN_SHAPES)
    cases = [
        (2, ((1, 7), (5, 1), (4, 6)), 777, (-0.2, 1.2)),
        (1, ((1, 1), (3, 9)), 1001, (-0.2, 1.2)),
        (TRAIN_BATCH, TRAIN_SHAPES, S_train, None),
    ]
    for B, shapes, Q, rng in cases:
        v, loc, attn = deform_inputs(B, shapes, Q, gen, dev, rng)
        v = v.to(torch.bfloat16)
        g = torch.randn(B, Q, M * D, generator=gen).to(dev)
        first = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        second = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
        torch.cuda.synchronize()
        want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
        if first[0].dtype != torch.bfloat16:
            raise AssertionError(f"d_value came back {first[0].dtype}, not bf16")
        scale = want[0].float().abs().max().item()
        errs = {}
        for name, a, b, w in zip(GRAD_TOL, first, second, want):
            a, b, w = a.float(), b.float(), w.float()
            if name == "d_value":
                tol = dict(rtol=BF16_D_VALUE_RTOL, atol=BF16_D_VALUE_ATOL_OF_MAX * scale)
                torch.testing.assert_close(a, w, msg=name, **tol)
                torch.testing.assert_close(a, b, msg="d_value repeat", **tol)
                errs["d_value_repeat"] = (a - b).abs().max().item()
            else:
                torch.testing.assert_close(a, w, msg=name, **GRAD_TOL[name])
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs between two runs of K2-bf16")
            errs[name] = (a - w).abs().max().item()
        log("check_bwd", kernel="ms_deform_attn_bwd_bf16", case="edge" if rng else "train",
            B=B, shapes=shapes, Q=Q, d_value_max=f"{scale:.3e}",
            **{f"{k}_max_abs_err": f"{e:.3e}" for k, e in errs.items()})
    L = len(TRAIN_SHAPES)
    k_ms = cuda_ms(lambda: ms_deform_attn_bwd_cuda(v, TRAIN_SHAPES, loc, attn, g), 20)
    p_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(v, TRAIN_SHAPES, loc, attn, g), 3)
    bound, by, n_bytes, flops = deform_bwd_bound_ms(B, TRAIN_SHAPES, Q, L, loc, value_bytes=2)
    log("time", kernel="ms_deform_attn_bwd_bf16", B=B, tiles=n_tiles(TRAIN_SHAPES, Q, True),
        ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
        bytes=n_bytes, flops=flops, share_of_bound=f"{bound / k_ms:.3f}")
    return max(errs[k] for k in GRAD_TOL), (k_ms, p_ms, bound, by)


def make_trainer_bf16(dev, seed=0):
    """The full-width trainer in the JAX train bench's bf16 configuration,
    deformable projections perturbed as `make_trainer`'s."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config(CONFIG, TRAIN_BF16), device=dev, seed=seed)
    perturb_deformable(trainer.model)
    return trainer


def train_path_bf16(trainer, dev):
    """Phase 16: the bf16 trainer's step at full width. Returns (K1-bf16 and
    K2-bf16 launches over the timed steps, the batch, the warm-up step's
    (B, L+1, Q, G) cost matrices)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.train.trainer import StageTimer, synthetic_batch

    t0 = time.perf_counter()
    batch = synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=0, device=dev)
    costs = []
    with _watch(trainer, "assign_fn", costs, lambda a, o: a[0].detach().clone()):
        trainer.step(batch)  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    log("train_setup_bf16", config=CONFIG, **{k.split(".")[-1]: v for k, v in TRAIN_BF16.items()},
        batch=TRAIN_BATCH, size=TRAIN_SIZE, instances=TRAIN_INSTANCES,
        seconds=f"{time.perf_counter() - t0:.2f}")
    torch.cuda.reset_peak_memory_stats()

    timer = StageTimer(dev)
    reset_counts()
    step_ms = []
    for i in range(TRAIN_STEPS):
        timer.start()
        t = time.perf_counter()
        metrics = {k: v.item() for k, v in trainer.step(batch, mark=timer).items()}
        step_ms.append((time.perf_counter() - t) * 1e3)
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"bf16 step {i}: non-finite {bad}")
        log("train_step_bf16", step=i, total_loss=f"{metrics['total_loss']:.4f}",
            loss_ce=f"{metrics['loss_ce']:.4f}", loss_mask=f"{metrics['loss_mask']:.4f}",
            loss_dice=f"{metrics['loss_dice']:.4f}",
            grad_norm=f"{metrics['grad_norm']:.4f}", step_ms=f"{step_ms[-1]:.2f}")
    launches = {"k1_bf16": ms_deform_attn_cuda.launches_bf16,
                "k2_bf16": ms_deform_attn_bwd_cuda.launches_bf16,
                "k1_f32": ms_deform_attn_cuda.launches, "k2_f32": ms_deform_attn_bwd_cuda.launches}
    layers = trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers
    want = {"k1_bf16": len(layers) * TRAIN_STEPS, "k2_bf16": len(layers) * TRAIN_STEPS,
            "k1_f32": 0, "k2_f32": 0}
    if launches != want:
        raise AssertionError(f"bf16 steps launched {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30

    grads = {}
    for i, layer in enumerate(layers):
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            w = getattr(layer.self_attn, name).weight.grad
            grads[f"{i}.{name}"] = 0.0 if w is None else w.abs().sum().item()
    zero = [k for k, v in grads.items() if not v > 0]
    if zero:
        raise AssertionError(f"no gradient reached encoder projections {zero}")
    dtypes = {p.dtype for p in trainer.model.parameters()} | {
        m.dtype for m in trainer.optimizer.mu + trainer.optimizer.nu}
    if dtypes != {torch.float32}:
        raise AssertionError(f"bf16 training holds parameters or moments in {dtypes}")
    log("train_grads_bf16", min_abs_sum=f"{min(grads.values()):.3e}",
        **{k.replace(".", "_"): f"{v:.3e}" for k, v in grads.items() if k.startswith("0.")})
    log("train_main_bf16", **{f"{k}_launches": v for k, v in launches.items()},
        step_ms_mean=f"{sum(step_ms) / len(step_ms):.2f}",
        step_ms_median=f"{statistics.median(step_ms):.2f}", peak_mem_gib=f"{peak:.2f}")
    log("train_stages_bf16", **{k: f"{v / TRAIN_STEPS:.2f}ms" for k, v in timer.ms.items()})
    return (launches["k1_bf16"], launches["k2_bf16"]), batch, costs[0]


def grad_parity_bf16(trainer, dev):
    """Phase 16, second part: one B=1 1024x1024 loss and every gradient of
    the bf16 trainer through K1-bf16 + K2-bf16 against autograd of the plain
    path in bf16, on the same weights, batch and random points."""
    from bm2f_tpu_torch.losses.criterion import draw_points
    from bm2f_tpu_torch.train.trainer import synthetic_batch

    batch = synthetic_batch(1, TRAIN_SIZE, TRAIN_INSTANCES, seed=1, device=dev)
    points = draw_points(trainer.ccfg, trainer.cfg.model.decoder.dec_layers + 1, 1,
                         torch.Generator(device=dev).manual_seed(5))
    names, params = zip(*trainer.model.named_parameters())
    res = {}
    for impl in ("auto", "plain"):
        total, _ = trainer.loss(batch, points, deform_impl=impl)
        res[impl] = (total.item(), torch.autograd.grad(total, params))
    (lk, gk), (lp, gp) = res["auto"], res["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    flat = [torch.cat([g.reshape(-1).double() for g in gs]) for gs in (gk, gp)]
    grad_rel = rel_err(flat[0], flat[1])
    parts = {}
    for part in ("backbone", "sem_seg_head.pixel_decoder", "sem_seg_head.predictor"):
        idx = [i for i, n in enumerate(names) if n.startswith(part + ".")]
        parts[part.split(".")[-1]] = rel_err(torch.cat([gk[i].reshape(-1) for i in idx]),
                                             torch.cat([gp[i].reshape(-1) for i in idx]))
    per = [rel_err(a, b) for a, b in zip(gk, gp)]
    worst = max(range(len(per)), key=per.__getitem__)
    log("grad_parity_bf16", loss_kernel=f"{lk:.6f}", loss_plain=f"{lp:.6f}",
        loss_rel=f"{loss_rel:.3e}", grads_rel=f"{grad_rel:.3e}",
        **{f"{k}_rel": f"{v:.3e}" for k, v in parts.items()},
        worst_param=f"{per[worst]:.3e}@{names[worst]}")
    if not (np.isfinite(lk) and loss_rel <= BF16_TRAIN_LOSS_REL
            and grad_rel <= BF16_TRAIN_GRAD_REL):
        raise AssertionError(f"bf16 kernel path against plain: loss {loss_rel:.3e} (limit "
                             f"{BF16_TRAIN_LOSS_REL}), gradients {grad_rel:.3e} (limit "
                             f"{BF16_TRAIN_GRAD_REL})")


def matcher_on_card(costs, valid):
    """Phase 17: `jv_assign` on the card against the host LAP on one step's
    (B, L+1, Q, G) costs; each timed (host clock to a synchronise, median of
    5 after one warm-up). Returns the two medians in ms."""
    from bm2f_tpu_torch.matching.hungarian import assign, jv_assign

    B, L1, Q, G = costs.shape
    flat = costs.reshape(B * L1, Q, G)

    def timed(fn):
        out, ms = None, []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(ms[1:])

    jv, jv_ms = timed(lambda: jv_assign(flat))
    host, host_ms = timed(lambda: assign(flat))
    if jv.device != costs.device or host.device != costs.device:
        raise AssertionError("an assignment left the costs' device")
    ok = valid.repeat_interleave(L1, 0)  # (B*(L+1), G)
    differ = int((jv != host)[ok].sum())
    cols = torch.arange(G, device=costs.device)
    total = [flat.double()[torch.arange(B * L1, device=costs.device)[:, None], a, cols]
             .where(ok, 0.0).sum(1) for a in (jv, host)]
    gap = (total[0] - total[1]).abs().max().item()
    one_to_one = all(len(set(r.tolist())) == G for r in jv.cpu())
    log("matcher", problems=B * L1, Q=Q, G=G, valid_targets=int(ok.sum()),
        assignments_differing=differ, max_total_cost_gap=f"{gap:.3e}",
        jv_device_ms=f"{jv_ms:.3f}", host_lap_ms=f"{host_ms:.3f}")
    if differ or gap > 1e-3 or not one_to_one:
        raise AssertionError(f"jv_assign on the card differs from the host LAP on {differ} "
                             f"valid targets (cost gap {gap}, one-to-one {one_to_one})")
    return jv_ms, host_ms


def _same_state(a, b) -> list:
    """The keys where two `Trainer.state_dict()`s differ in any bit."""
    bad = [k for k in ("step",) if a[k] != b[k]]
    bad += [f"model.{k}" for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    bad += [k for k in ("count",) if a["optimizer"][k] != b["optimizer"][k]]
    for m in ("mu", "nu"):
        bad += [f"{m}.{k}" for k in a["optimizer"][m]
                if not torch.equal(a["optimizer"][m][k], b["optimizer"][m][k])]
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    return bad


def checkpoint_resume(trainer, batch, dev):
    """Phase 18: save the trainer, resume a fresh one (another seed) from
    the checkpoint, check the whole state bitwise, then one more step from
    each."""
    from bm2f_tpu_torch.train.checkpoint import Checkpointer

    out_dir = ROOT / "output"
    out_dir.mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=out_dir)
    try:
        ckpt = Checkpointer(directory)
        t0 = time.perf_counter()
        ckpt.save(trainer.step_count, trainer)
        save_s = time.perf_counter() - t0
        fresh = make_trainer_bf16(dev, seed=1)
        t0 = time.perf_counter()
        step = ckpt.resume_or_load(fresh, resume=True)
        restore_s = time.perf_counter() - t0
        size_mb = sum(f.stat().st_size for f in Path(directory).rglob("*") if f.is_file()) / 1e6
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    bad = _same_state(fresh.state_dict(), trainer.state_dict())
    if step != trainer.step_count or bad:
        raise AssertionError(f"resumed at {step} of {trainer.step_count}; differing: {bad[:8]}")
    after = [{k: v.item() for k, v in t.step(batch).items()} for t in (trainer, fresh)]
    loss_rel = max(abs(after[1][k] - after[0][k]) / abs(after[0][k])
                   for k in after[0] if k != "grad_norm")
    gn_rel = abs(after[1]["grad_norm"] - after[0]["grad_norm"]) / after[0]["grad_norm"]
    log("resume", step=step, checkpoint_mb=f"{size_mb:.1f}", save_s=f"{save_s:.2f}",
        restore_s=f"{restore_s:.2f}", state_keys=len(trainer.state_dict()["model"]),
        next_total_loss=f"{after[0]['total_loss']:.6f}",
        max_loss_rel=f"{loss_rel:.3e}", grad_norm_rel=f"{gn_rel:.3e}")
    if not (loss_rel <= RESUME_LOSS_RTOL and gn_rel <= RESUME_GRAD_NORM_RTOL):
        raise AssertionError(f"the resumed step differs: losses {loss_rel:.3e} (limit "
                             f"{RESUME_LOSS_RTOL}), grad_norm {gn_rel:.3e} (limit "
                             f"{RESUME_GRAD_NORM_RTOL})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "bm2f_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: bm2f_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bm2f_tpu_torch.ops import cuda_build
    from bm2f_tpu_torch.ops.deform_attn import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_cuda,
        ms_deform_attn_plain,
    )
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log("device", name=repr(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(f"nvidia-smi: {smi}", flush=True)

    # -- 2. build -----------------------------------------------------------
    sources = sorted(p.name for ext in ("*.cu", "*.cpp") for p in cuda_build.CSRC_DIR.glob(ext))
    t0 = time.perf_counter()
    built = cuda_build.build(sources)
    log("build", sources=",".join(sources), seconds=f"{time.perf_counter() - t0:.2f}")
    for src, (lib, secs, compiler_log) in built.items():
        ptxas = [ln.strip() for ln in compiler_log.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        log("build", source=src, seconds=f"{secs:.2f}", ptxas=repr(" | ".join(ptxas)))

    # -- 3. kernel against its plain version --------------------------------
    gen = torch.Generator().manual_seed(0)
    edge = [  # H=1 and W=1 levels, locations in [-0.2, 1.2], Q not a power of 2
        (2, ((1, 7), (5, 1), (4, 6)), 777, (-0.2, 1.2)),
        (1, ((1, 1), (3, 9)), 1001, (-0.2, 1.2)),
    ]
    for B, shapes, Q, rng in edge:
        v, loc, attn = deform_inputs(B, shapes, Q, gen, dev, rng)
        got = ms_deform_attn_cuda(v, shapes, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(v, shapes, loc, attn)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        log("check", case="edge", B=B, shapes=shapes, Q=Q,
            max_abs_err=f"{(got - want).abs().max().item():.3e}")
    S_main = sum(h * w for h, w in MAIN_SHAPES)
    main_inputs, max_err = {}, 0.0
    for B in (1, 4):
        v, loc, attn = deform_inputs(B, MAIN_SHAPES, S_main, gen, dev)
        got = ms_deform_attn_cuda(v, MAIN_SHAPES, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(v, MAIN_SHAPES, loc, attn)
        err = (got - want).abs().max().item()
        # each output sums 48 weighted samples in another order
        if not err <= 1e-4:
            raise AssertionError(f"main-path B={B}: max abs err {err} > 1e-4")
        if B == 1:
            max_err = err
        main_inputs[B] = (v, loc, attn)
        log("check", case="main", B=B, Q=S_main, max_abs_err=f"{err:.3e}")
    del got, want

    # -- 4. kernel timing ---------------------------------------------------
    timing = {}
    for B, (v, loc, attn) in main_inputs.items():
        k_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, MAIN_SHAPES, loc, attn), 50)
        p_ms = cuda_ms(lambda: ms_deform_attn_plain(v, MAIN_SHAPES, loc, attn), 10)
        g_ms = cuda_ms(lambda: grid_sample_composite(v, MAIN_SHAPES, loc, attn), 10)
        bound, by, n_bytes, flops = deform_bound_ms(B, MAIN_SHAPES, S_main, 3, loc)
        timing[B] = (k_ms, p_ms, bound, by)
        log("time", kernel="ms_deform_attn_fwd", B=B, tiles=n_tiles(MAIN_SHAPES, S_main, False),
            ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", grid_sample_composite_ms=f"{g_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes, flops=flops,
            share_of_bound=f"{bound / k_ms:.3f}")
    del main_inputs

    # -- 5. main path -------------------------------------------------------
    pred = Predictor()
    t0 = time.perf_counter()
    pred.setup(CONFIG, device="cuda", seed=0)
    perturb_deformable(pred.model)  # general sampling locations, not a grid
    torch.cuda.synchronize()
    log("setup", config=CONFIG, seconds=f"{time.perf_counter() - t0:.2f}",
        params=sum(p.numel() for p in pred.model.parameters()))
    img_rng = np.random.RandomState(0)
    images = [img_rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUESTS]
    pred.predict(images[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    serve(pred, images, "f32")
    launches, k2_serve = ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches
    if (launches, ms_deform_attn_cuda.launches_bf16) != (6 * len(images), 0):
        raise AssertionError(f"ms_deform_attn_fwd launched {launches} times in f32 and "
                             f"{ms_deform_attn_cuda.launches_bf16} in bf16, expected "
                             f"{6 * len(images)} and 0")
    if k2_serve != 0:  # serving takes no gradient
        raise AssertionError(f"ms_deform_attn_bwd launched {k2_serve} times in serving")
    log("main", launches=launches, k2_launches=k2_serve,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    model = pred.model
    x = stage_split(pred, images[0], "f32")

    # -- 6. forward parity: kernel path vs plain path -----------------------
    with torch.no_grad():
        xn = normalize_images(x.to(dev), pred.cfg.model)
        a = model(xn)
        b = model(xn, deform_impl="plain")
    for key in ("pred_logits", "pred_masks"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-3, atol=1.5e-3)
        log("parity", key=key, max_abs_diff=f"{(a[key] - b[key]).abs().max().item():.3e}")

    del pred, model, a, b
    torch.cuda.empty_cache()

    # -- 7. K2 against its plain version -------------------------------------
    k2_err, k2_inputs = check_k2(dev, gen)

    # -- 8. K2 (and K1) timing at the train-path shapes ----------------------
    k2_ms, k2_plain_ms, k2_bound, k2_by = time_k2(k2_inputs)
    del k2_inputs
    torch.cuda.empty_cache()

    # -- 9. gradient parity at the seeded init ---------------------------------
    trainer = make_trainer(dev)
    grad_parity(trainer, dev, "init")

    # -- 10. the train path ---------------------------------------------------
    k1_train, k2_train = train_path(trainer, dev)

    # -- 11. gradient parity at the trained state -----------------------------
    grad_parity(trainer, dev, "trained")
    del trainer
    torch.cuda.empty_cache()

    # -- 12. the gather probe (K3, K4) ------------------------------------------
    probe_lines, probe_counts = probe_path()
    torch.cuda.empty_cache()

    # -- 13. K1 on a bf16 value ---------------------------------------------------
    k1b_err, (k1b_ms, k1b_plain_ms, k1b_bound, k1b_by) = check_k1_bf16(dev, gen)
    torch.cuda.empty_cache()

    # -- 14. bf16 serving -----------------------------------------------------------
    bf16_launches = serve_bf16(dev, images)
    torch.cuda.empty_cache()

    # -- 15. K2 on a bf16 value ---------------------------------------------------
    k2b_err, (k2b_ms, k2b_plain_ms, k2b_bound, k2b_by) = check_k2_bf16(dev, gen)
    torch.cuda.empty_cache()

    # -- 16. the bf16 train path ------------------------------------------------------
    trainer = make_trainer_bf16(dev)
    (k1b_train, k2b_train), batch, step_costs = train_path_bf16(trainer, dev)
    grad_parity_bf16(trainer, dev)

    # -- 17. the matcher on the card ----------------------------------------------------
    matcher_on_card(step_costs, batch["valid"])

    # -- 18. checkpoint and resume --------------------------------------------------------
    checkpoint_resume(trainer, batch, dev)
    del trainer, batch
    torch.cuda.empty_cache()

    # -- 19. result ---------------------------------------------------------
    k_ms, p_ms, bound, by = timing[1]
    k1_pd_f32 = bf16_launches["bf16_pd_f32"][0]
    kernels = [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:102",
        "launches": launches + k1_train + k1_pd_f32,
        "launches_by_path": {"serve": launches, "train": k1_train,
                             "serve_bf16_pixel_decoder_f32": k1_pd_f32},
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }, {
        "name": "ms_deform_attn_bwd",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_bwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:118",
        "launches": k2_train,
        "launches_by_path": {"serve": k2_serve, "train": k2_train, "train_bf16": 0},
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "ms_deform_attn_fwd_bf16",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:102",
        "launches": bf16_launches["bf16"][1] + k1b_train,
        "launches_by_path": {"serve_bf16": bf16_launches["bf16"][1], "train_bf16": k1b_train},
        "max_abs_err": k1b_err,
        "ms": k1b_ms,
        "plain_ms": k1b_plain_ms,
        "bound_ms": k1b_bound,
        "bound_by": k1b_by,
        "library_ms": None,
    }, {
        "name": "ms_deform_attn_bwd_bf16",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_bwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:118",
        "launches": k2b_train,
        "launches_by_path": {"train_bf16": k2b_train},
        "max_abs_err": k2b_err,
        "ms": k2b_ms,
        "plain_ms": k2b_plain_ms,
        "bound_ms": k2b_bound,
        "bound_by": k2b_by,
        "library_ms": None,
    }]
    # the probe's kernels, each at its row's shapes (S=2500, random addresses)
    for name, impl, source, line_no in (
            ("gather_rows_f32", "scalar", "gather_rows.cu", 59),
            ("gather_rows_bf16", "scalar_bf16", "gather_rows.cu", 110),
            ("gather_onehot_f32", "onehot", "gather_onehot_mma.cu", 80),
            ("gather_onehot_bf16", "onehot_bf16", "gather_onehot_mma.cu", 97)):
        row = next(ln for ln in probe_lines
                   if ln["impl"] == impl and all(ln[k] == v for k, v in PROBE_ROW.items()))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"bm2f_tpu_torch/csrc/{source}",
            "replaces": f"tools/roofline_microbench.py:{line_no}",
            "launches": probe_counts[name],
            "launches_by_path": {"probe": probe_counts[name]},
            "max_abs_err": max(ln["max_err_vs_plain"] for ln in probe_lines
                               if ln["impl"] == impl),
            "ms": row["ms_per_level_layer"],
            "plain_ms": row["plain_ms"],
            # the function's bound (bytes), the same for K3 and K4
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["embedding_bag_ms"],
            # K4 only: its dense one-hot products on the tensor cores, and
            # the products it issues (fragments that hold a one), apart
            **({"onehot_tc_bound_ms": row["onehot_tc_bound_ms"],
                "onehot_hit_tc_bound_ms": row["onehot_hit_tc_bound_ms"]}
               if row["onehot_tc_bound_ms"] is not None else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
