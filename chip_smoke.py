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
     the card: edge cases and the train-path shapes, each run twice and
     once more with its tiles in reverse order and the queries of each
     shuffled, all three gradients bitwise equal every time;
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
 12b. the box matcher's pairwise sums (`csrc/pairwise_cost.cu`) against
     their plain version at the box cell's shape (Q 100, 216 x 352, K 8),
     at a ragged shape and at (5, 2); two launches bitwise equal; timed
     beside the plain version, the matcher's whole pairwise cost and the
     bound; phases 24 and 31 count its launches in the weak steps;
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
     train-path shapes, run as in phase 7 (bitwise equal across runs and
     tile orders), then timed (the wrapper calls) beside the plain version,
     the bound and autograd of the bf16 grid_sample composite;
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
     gradient norms within the tolerance of cuDNN's backward;
 19. the eval's data: a seeded synthetic dataset in the COCO formats at COCO
     val2017 sizes (`bm2f_tpu_torch.data.synthetic`: instances with RLE
     masks and crowd regions, panoptic PNGs, semantic PNGs with 255
     ignored), written to a temporary directory and registered as the
     builtin COCO and ADE20K splits;
 20. the eval path: `bm2f_tpu_torch.eval.run_eval` on `coco_instance_r50` at
     full width with seeded random weights, the test resize 800 / 1333 and
     its buckets (672, 992, 1344; the images fall in 992 and 1344): mask AP
     (`coco`), mIoU (`sem_seg`) and PQ (`coco_panoptic_seg`) in f32, and AP
     in bf16, every count set to 0 just before each run and read just after
     (K1 6 launches an image, K1-f32 none in bf16); the metrics, warm images
     per second and the first image of each bucket apart, peak memory;
 21. each evaluator fed the ground truth as its predictions: AP = mIoU =
     PQ = 100 exactly;
 22. K1 and K1-bf16 at the eval buckets 992 and 1344 (B=1), on the first
     encoder layer's inputs of one synthetic image of each, against the
     plain version and timed beside it and the bound;
 23. weights: the f32 eval model saved with the port's `Checkpointer`,
     loaded through `Predictor.setup(weights=...)` (what `--weights`
     calls) with the same predictions bitwise, and through the entry point
     `python -m bm2f_tpu_torch.eval --weights` with the same metrics; where
     tensorstore is missing, the orbax reader's named ImportError;
 24. the weak train path: `Trainer` on `coco_instance_r50_wo_lsj_projpair`
     at full width (box-supervised: projection and pairwise losses, the
     pseudo-mask update on, the pairwise warmup over 1 step), B=2 on the
     864x1408 canvas, its batches from phase 19's split through
     `MaskFormerInstanceMapper` and `build_train_loader` (targets padded to
     G=100): one warm-up step and 3 timed steps with every count set to 0
     just before and read just after (K1 and K2 6 launches a step, none on
     a bf16 value); finite losses, nonzero projection and pairwise losses,
     nonzero gradients of every encoder layer's deformable projections,
     the split by stage and peak memory; then the mask-supervised
     `coco_instance_r50_wo_lsj` on the same batches, timed the same way;
 25. the weak step's loss and every gradient through the kernels against
     the plain path on the same batch, and two trainers from one seed
     ending two weak steps with the same bits;
 26. the train entry point as a subprocess on the card: `python -m
     bm2f_tpu_torch.train --config coco_instance_r50_proj --dataset
     coco_2017_val --eval-dataset coco_2017_val --max-iter 4` on phase 19's
     split (B=2, an eval and a checkpoint every 2 steps): the loss scalars
     and eval/ metrics in metrics.json at iteration 2, checkpoints at 2 and
     4, then `--eval-only --resume` on the checkpoint at 4;
 27. the video data: a seeded synthetic YouTube-VIS split
     (`bm2f_tpu_torch.data.synthetic.write_synthetic_ytvis`: 1280x720 JPEG
     frames, per-frame RLE with null where an object is absent, a crowd
     track a video), `ytvis_2019_val` of 3 videos of 5, 19 and 36 frames
     (the eval's 8, 24 and 40 frame buckets, all at its 640 spatial bucket)
     and `ytvis_2021_train` with a DINO grid (26x46x384) a frame whose
     patches keep their feature as the objects move, registered;
 28. the video eval: `bm2f_tpu_torch.eval_video.run_video_eval` on
     `ytvis2019_video_r50` at full width with seeded random weights, twice
     (the first clip of each (frames, size) bucket, then warm), every count
     set to 0 just before and read just after (K1 6 launches a clip, over
     its Tp frames); AP, warm frames per second, the first clip of each
     bucket apart, peak memory; then the ground truth as predictions, which
     must score AP 100 exactly;
 29. padding on the card: the 5-frame clip at its true length against the
     same clip padded to its 8-frame bucket with `frame_valid`, logits and
     masks within the forward's card tolerance; then stage by stage (the
     backbone's levels and the pixel decoder's outputs on the valid frames,
     batch 5 against batch 8, then the decoder's outputs), with cuDNN as
     the eval runs it and with one algorithm forced;
 30. K1 at the video eval shapes (Tp 8 and 40 at S 640, on the first encoder
     layer's inputs of a clip of each) and K2 at the video train shape (2
     clips x 2 frames at 512x512, encoder-like inputs as phase 7's), each
     against its plain version (K2 bitwise across runs and tile orders),
     timed beside it and its bound;
 31. video training (first K2 on a video batch's first-layer inputs against
     an f64 backward, beside the plain f32 backward's error): `Trainer` on
     `ytvis2021_video_r50` (masks) and on
     `ytvis2021_video_r50_proj_spatpair_temppair` (boxes, spatial and
     temporal pairwise losses, the pairwise warmup over 1 step), B=2 clips
     of 2 frames at 512x512, G=100, on batches of phase 27's train split
     through the ported mappers (`ytvis`; `ytvis_with_feats` with the
     synthetic DINO grids' root) and `build_train_loader`: one warm-up step
     and 3 timed steps with every count set to 0 just before and read just
     after (K1 and K2 6 launches a step); finite losses, nonzero
     projection, spatial and temporal pairwise losses, nonzero gradients of
     every encoder layer's deformable projections, the split by stage and
     peak memory;
 32. the weak video step's loss and every gradient through the kernels
     against the plain path (K2 against the plain backward on the same
     forward, and the whole path), and two trainers from one seed ending two
     steps with the same bits;
 33. the train entry point as a subprocess on the card: `python -m
     bm2f_tpu_torch.train --config ytvis2021_video_r50_proj_spatpair_temppair
     --dataset ytvis_2021_train --eval-dataset ytvis_2019_val --max-iter 2`
     on phase 27's splits (an eval at step 1, a checkpoint at 2), then
     `--eval-only --resume`, the eval at step 2;
 34. Swin-L (`coco_instance_swin_l`'s backbone, seeded) at B=2, 1024x1024
     in f32 against the same backbone in f64 on the card, each level
     norm-relative (SWIN_F64_REL: TF32 leaking into a window product, or a
     mask or roll that differs on the card, shows here), both timed;
 35. serving `coco_instance_swin_l` at full width (Swin-L, window 12, 200
     queries, 6 encoder and 9 decoder layers, seeded): the 3 requests
     twice (the 480x640 and 800x1088 ones first at their shape, then
     warm), every count set to 0 just before and read just after (K1 6
     launches a request, K2 none); the stage split, peak memory, the kernel
     path against the plain path, K1 on a request's first-layer inputs; one
     bf16 request (`model.dtype=bfloat16`) against the f32 kernel path;
 36. training `coco_instance_swin_l`: gradient parity at the seeded init
     (phase 9's, B=1), then phase 10's path (B=2, 1024x1024, 8 targets, one
     warm-up and 3 timed steps, K1 and K2 6 launches a step, the split by
     stage, peak memory), gradients in every Swin stage's `qkv` and bias
     tables, and two trainers from one seed ending two steps with the same
     bits (the bias tables' backward under deterministic algorithms);
 37. the video eval on `ytvis2019_video_swin_l` (Swin-L, its 480 test
     size) at full width: the first clip of phase 27's val split (5 frames,
     the 8-frame bucket) twice, every count set to 0 just before and read
     just after (K1 6 launches a clip); first and warm time, peak memory,
     K1 on the clip's first-layer inputs;
  G1-G3. data-parallel training (`bm2f_tpu_torch/parallel/`), after 18 (G3
     after 26, on phase 19's split):
  G1. `parallel.init_distributed` starts a world-1 NCCL group; its trainer
     is wrapped in `DistributedDataParallel` with the summing hook; 3 steps
     at B=2, 1024x1024 bitwise equal to 3 steps of the plain trainer from
     the same seed (metrics and the whole state), every count set to 0
     just before and read just after (K1 and K2 6 launches a step);
  G2. two spawned processes on the one card in a gloo group started here
     (the package never picks gloo on the card), each 1 image of the same
     global B=2 batches, 2 steps, against one process on the global
     batches: the first step's losses and grad_norm within G2_REL, its
     update within AdamW's bound on a gradient G2_REL off, the second
     step's total loss within what the first update's differences move it
     by (to first order, doubled), the two ranks' parameters bitwise equal
     after every step, K1 and K2 6 launches a step on each rank (counted
     in the ranks);
  G3. phase 26's run as the one rank of `python -m torch.distributed.run
     --nproc-per-node 1 -m bm2f_tpu_torch.train --distributed` (NCCL):
     trains with an eval and checkpoints, then `--eval-only --resume`;
  T1-T3. tensor parallelism (`bm2f_tpu_torch/parallel/tp.py`), after G2:
  T1. K1 and K2 at a rank's share of the deformable heads, M/T = 4 and 2
     (D = 32), at the train shapes (B=2, 1024x1024): each against its plain
     version, K2 twice and once with its tiles reversed (all three bitwise
     equal), both timed beside the plain versions and the bound at M/T;
  T2. two spawned processes on the one card in a gloo group at mesh (data
     1, model 2), each training the whole global B=2 batch on its share of
     the wide parameters, 2 steps, against one process: the first step's
     losses and grad_norm within G2_REL, its update within AdamW's bound,
     the replicated parameters bitwise equal across the ranks after every
     step, K1 and K2 6 launches a step on each rank, on 4 heads, each
     rank's parameter and moment bytes the rules' count; step time and peak
     memory per rank;
  T3. T2's checkpoint (the gathered state, written by rank 0) resumed by
     one process: its state bitwise the file's; its next step against the
     ranks' within G2_REL (losses) and RESUME_GRAD_NORM_RTOL (grad_norm);
  A-F. the user entry points and the MaskFormer-v1 models, each where its
     data lives (B, D and E after 26 on phase 19's split, C after 37 on
     phase 27's, A and F after the video phases), every count set to 0
     just before each run and read just after:
  A. the `Predictor` with its default config (`coco_panoptic_r50`) at full
     width: 3 requests at 800x800 with the visualization (H, 3W, 3) uint8,
     the drawing timed apart, then `python -m bm2f_tpu_torch.predict`
     writing one (K1 6 launches a request);
  B. `python -m bm2f_tpu_torch.demo` (its `main`) over phase 19's images
     at their native sizes for each task, one PNG an image; the panoptic
     task at depth 1 and 2: the pipeline's wall time against the sum of its
     stages (K1 6 launches an image);
  C. `python -m bm2f_tpu_torch.demo_video` on phase 27's 19-frame clip at
     its native 1280x720: one PNG a frame, time, peak memory (K1 6
     launches, one forward);
  D. `run_eval(tta=True)` on `ade20k_semantic_r50` over 3 images of phase
     19's ade20k_sem_seg_val (12 forwards an image, K1 72 launches an
     image), images/s, peak memory; one image's averaged probabilities
     through K1 against the plain path;
  E. `retry_if_oom` forced: the process capped between the peaks of an
     eval batch of 4 images at the 1344 bucket and of its half, so that the
     batch splits (at least once) and matches the uncapped run, `run_eval`
     with the same AP capped and not; an image that cannot fit raises at
     batch 1; the cap lifted;
  F. MaskFormer-v1 on `coco_instance_r50`: the FPN pixel decoder, and
     `transformer_fpn` + `standard` at MaskFormer-v1's setting: 3 f32
     requests and 1 bf16 request at 800x800, the f32 forward against an
     f64 copy (V1_F64_REL), 3 train steps at B=2, 1024x1024 (no K1 or K2
     launch);
  H1-H5. the root tools (`bm2f_tpu_torch/tools/`), H1-H4 after F, H5
     after E on phase 19's split, every count set to 0 just before each
     and read just after, their iteration counts cut (H_ITERS), never
     their shapes:
  H1. `profile_forward` at its config (`coco_instance_r50` in bf16, B=4,
     800x800): each segment's time; K1 on a bf16 `value` 6 launches a full
     forward and 6 a 6-layer pixel decoder; the raw op at the encoder's
     shapes against `ms_deform_attn_plain` (phase 13's tolerance);
  H2. `profile_kernel`: K1's full call, its preparation and its launch
     alone at B=4, 800x800 on a bf16 `value`; the full call no faster than
     the launch alone, whose output is bitwise the full call's;
  H3. `profile_criterion --iters 3`: the criterion's value and gradient
     with `jv_assign` at the train shapes, a finite loss, its ms a step
     (no K1 or K2 launch);
  H4. `analyze_model` on `coco_instance_r50` at 800: the parameter table
     and the FLOPs through K1 (6 launches) equal to the FLOPs with the
     deformable core routed through `ms_deform_attn_plain`;
  H5. `zoo_parity` from a seeded f32 model saved with the port's
     Checkpointer, on phase 19's images with the model's own predictions
     as their instances (its AP depends on the weights): exit 0 with
     `--expected AP=<the AP run_eval gives it in memory>` at tolerance
     1e-6, exit 1 against the zoo's AP 43.7, and the gate failing from
     another seed's checkpoint (K1 6 launches an image in each eval);
 38. one JSON line {"kernels": [...]}, then the nvidia-smi line, then the
     result line {"ok": true, "device": {...}} last.

Every request of the `Predictor` (phases 5, 14, 35, A, F) draws its
visualization; the drawing, host time, is in the request's latency and is
logged apart (`draw_ms`).

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
# through cuDNN's backward, whose sums may run in another order each time.
# Read on an H100: losses equal, gradient norm 6.4e-6 (with K2's atomics)
RESUME_LOSS_RTOL, RESUME_GRAD_NORM_RTOL = 1e-6, 1e-4
# (run, dataset the synthetic root registers, config overrides)
EVAL_RUNS = (("coco", "coco_2017_val", {}), ("sem_seg", "ade20k_sem_seg_val", {}),
             ("coco_panoptic_seg", "coco_2017_val_panoptic", {}),
             ("coco_bf16", "coco_2017_val", BF16))
EVAL_BUCKETS = {992: 4, 1344: 0}  # bucket: index of an image of that bucket
# the weak train path (phases 24-26): the box-supervised preset on the fixed
# 864x1408 canvas of its mapper, the pairwise warmup over one step (at the
# preset's 10000 the pairwise loss is 0 in the first steps and proves
# nothing), the pseudo-mask update on; and the mask-supervised preset of the
# same mapper, so that the weak criterion's own cost shows
WEAK_CONFIG, WEAK_MASK_CONFIG = "coco_instance_r50_wo_lsj_projpair", "coco_instance_r50_wo_lsj"
WEAK_OVER = {"train.ims_per_batch": 2, "model.loss.weak.pairwise.warmup_iters": 1,
             "model.loss.weak.mask_update_enabled": True}
# the entry point's run (phase 26)
ENTRY_CONFIG, ENTRY_ITERS, ENTRY_PERIOD = "coco_instance_r50_proj", 4, 2
# the video slice (phases 27-33): the synthetic split's val lengths (the
# eval's 8, 24 and 40 frame buckets), the eval's preset, the train presets
# (masks, and boxes with both pairwise losses) at 2 clips a step with the
# pairwise warmup over one step, and the buckets whose K1 rows the kernels
# line carries
VIDEO_LENGTHS = (5, 19, 36)
VIDEO_CONFIG = "ytvis2019_video_r50"
VIDEO_MASK_CONFIG = "ytvis2021_video_r50"
VIDEO_WEAK_CONFIG = "ytvis2021_video_r50_proj_spatpair_temppair"
VIDEO_OVER = {"train.ims_per_batch": 2, "model.loss.weak.pairwise.warmup_iters": 1}
VIDEO_K1_FRAMES = (8, 40)
VIDEO_WEAK_LOSSES = ("loss_mask_projection", "loss_mask_spatial_pairwise",
                     "loss_mask_temporal_pairwise")
# phase 29: the decoder in f64 on the padded clip against the clip at its
# true length (both with a frame mask, so with the same temporal table): the
# padded keys get exactly zero weight, so only f64 rounding (1e-16 of a
# sum, amplified at most ~1e4 through the layers) separates them; padded
# frames leaking into valid ones would move the outputs by 1e-3 or more
PAD_F64_ABS = 1e-6
# the Swin slice (phases 34-37): Swin-L (window 12, embed 192, 200 queries)
# serving, training and the video eval at its 480 test size
SWIN_CONFIG, SWIN_VIDEO_CONFIG = "coco_instance_swin_l", "ytvis2019_video_swin_l"
# Swin-L's backbone at B=2, 1024x1024, f32 against f64 on the card, each
# level norm-relative. f32 rounds each product of up to 4C = 6144 terms
# (u = 6e-8, ~sqrt(K) u relative) through 24 blocks that LayerNorm
# renormalises: 1e-6 to 1e-5. TF32 in a window product (u = 4.9e-4) would
# put 1e-3 or more there
SWIN_F64_REL = 2e-4
# the probe: level sizes of every impl; CUDA-event launches
PROBE_LEVELS, PROBE_ITERS = (625, 2500, 10000), 20
# the probe's row of each kernel in the kernels line
PROBE_ROW = dict(S=2500, addresses="random")
# the user entry points and the MaskFormer-v1 models (phases A-F): the
# predictor's and the demo's default panoptic config; the video demo's clip
# (phase 27's 19-frame video at its native 1280x720); the TTA eval's config
# and images of phase 19's ade20k_sem_seg_val (12 forwards an image: 6
# scales, each flipped); the eval batch that phase E makes run out of memory
# at the 1344 bucket
PANOPTIC_CONFIG = "coco_panoptic_r50"
DEMO_VIDEO_FRAMES = 19
TTA_CONFIG, TTA_IMAGES, TTA_FORWARDS = "ade20k_semantic_r50", 3, 12
OOM_BATCH, OOM_BUCKET = 4, 1344
# phase E's caps: the memory kept before the batch plus these shares of its
# half's measured peak, tried in turn until the batch splits
OOM_HALF_SHARES = (1.0, 0.85, 0.7, 0.55)
# the capped eval's cap: half the half's peak more (it also holds split
# outputs and restores masks; the batch, needing over twice what did not
# fit in a half, still cannot fit)
OOM_EVAL_EXTRA_SHARE = 0.5
# phase F: the FPN pixel decoder under the masked decoder, and MaskFormer-
# v1's own setting (a 6-layer post-norm encoder at res5, 6 DETR decoder
# layers, 100 queries, width 256, FFN 2048), on `coco_instance_r50`
V1_RUNS = {
    "fpn": {"model.pixel_decoder.name": "fpn"},
    "transformer_fpn_standard": {
        "model.pixel_decoder.name": "transformer_fpn", "model.decoder.name": "standard",
        "model.pixel_decoder.transformer_enc_layers": 6,
        "model.pixel_decoder.transformer_dim_feedforward": 2048,
        "model.decoder.dec_layers": 6, "model.decoder.num_queries": 100,
        "model.decoder.hidden_dim": 256, "model.decoder.dim_feedforward": 2048},
}
# a v1 model's f32 request at 800x800 against its f64 copy on the card,
# norm-relative on pred_logits and pred_masks: f32 rounds each product of up
# to 9 x 2048 terms (~sqrt(K) 6e-8 relative) through the ResNet, the FPN and
# 12 transformer layers that the norms renormalise: 1e-6 to 1e-5; TF32
# anywhere (u = 4.9e-4) would put 1e-3 there. Held as Swin-L's backbone is
V1_F64_REL = 2e-4
# the data-parallel phases (G1-G3): G1's steps of the world-1 NCCL group
# against the plain trainer (bitwise), G2's steps of two ranks on the one
# card (gloo), each taking 1 image of phase 10's global B=2 batch
DDP_STEPS, G2_STEPS = 3, 2
# G2 against the one process on the global batch: the sums of f32 terms in
# another order, nothing else (each rank's batch of one runs cuDNN's and
# cuBLAS's kernels at another batch, which may block their sums otherwise,
# and the two ranks' gradients add on the host through gloo): the losses
# and grad_norm within G2_REL, and the first update of every parameter
# within the bound AdamW puts on a gradient G2_REL off (`adam_update_bound`;
# the CPU's SMALL step reads 4.7e-6 on the losses and 1.2e-5 of a tensor's
# gradient norm between world sizes, tests/torch_ddp_cases.py, held at 1e-4
# there and here)
G2_REL = 1e-4
# the tensor-parallel phases (T1-T3): a rank's share of the deformable
# heads at T = 2 and 4; two ranks at mesh (data 1, model 2) on the one card
# (gloo), each the whole global B=2 batch, 2 steps, then a checkpoint and a
# third step. T2 against one process is G2's comparison (the sums of f32
# terms in another order: a row-parallel layer sums two partial products,
# f sums two partial gradients), held at G2_REL. T3 resumes T2's
# checkpoint in one process: the state bitwise, and its next step against
# T2's within G2_REL (phase 18's RESUME_LOSS_RTOL holds a resume of the
# same computation; this one resumes at another mesh, whose sums run in
# another order) and grad_norm within RESUME_GRAD_NORM_RTOL
TP_MODEL, T2_STEPS = 2, 2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (the port's
    timer, `tools/device.timed_ms`)."""
    from bm2f_tpu_torch.tools.device import timed_ms

    return timed_ms(fn, iters, warmup)


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


def deform_bound_ms(B, shapes, Q, L, loc, value_bytes=4, M=M):
    """K1: reads value (`value_bytes` an element), loc, attn once and writes
    the f32 output once; one FMA per valid corner and channel. `M` heads
    (a rank's share under tensor parallelism)."""
    S = sum(h * w for h, w in shapes)
    n_bytes = (value_bytes * B * S * M * D
               + 4 * (B * Q * M * L * P * 2 + B * Q * M * L * P + B * Q * M * D))
    flops = 2 * D * valid_corners(shapes, loc)
    return (*bound_ms(n_bytes, flops), n_bytes, flops)


def deform_bwd_bound_ms(B, shapes, Q, L, loc, value_bytes=4, M=M):
    """K2: reads value, loc, attn and grad_out once and writes d_value,
    d_loc and d_attn once (value and d_value `value_bytes` an element, the
    rest f32); per valid corner and channel one FMA for the dot product and
    a multiply and an add into d_value. `M` heads."""
    S = sum(h * w for h, w in shapes)
    n_bytes = value_bytes * 2 * B * S * M * D \
        + 4 * 2 * (B * Q * M * L * P * 2 + B * Q * M * L * P) + 4 * B * Q * M * D
    flops = 4 * D * valid_corners(shapes, loc)
    return (*bound_ms(n_bytes, flops), n_bytes, flops)


def grid_sample_composite(value, shapes, loc, attn):
    """Per-level `F.grid_sample` composite of the same function, in
    `value`'s dtype (f32 output) — a yardstick only; the port never calls
    it."""
    import torch.nn.functional as F

    B, S, M_, D_ = value.shape
    Q, L = loc.shape[1], len(shapes)
    out = torch.zeros(B, M_, D_, Q, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 3, 1).reshape(B * M_, D_, H, W)
        start += H * W
        g = (loc[:, :, :, lid] * 2 - 1).permute(0, 2, 1, 3, 4).reshape(B * M_, Q, P, 2)
        g = g.to(value.dtype)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False).reshape(B, M_, D_, Q, P)
        out += (s * attn[:, :, :, lid].permute(0, 2, 1, 3)[:, :, None]).sum(-1)
    return out.permute(0, 3, 1, 2).reshape(B, Q, M_ * D_)


def reversed_tables(shapes, Q, dev):
    """K2's tile tables with the tiles in reverse order and the queries of
    each shuffled (seeded), as `_device_plan` returns them."""
    from bm2f_tpu_torch.ops.deform_attn import tile_plan

    plan = tile_plan(shapes, Q, cells=True)
    rng = np.random.RandomState(3)
    ptr = plan.tile_ptr
    tiles = [rng.permutation(plan.tile_q[ptr[t]:ptr[t + 1]]) for t in range(len(ptr) - 1)]
    tile_ptr = np.concatenate([[0], np.cumsum([len(t) for t in tiles[::-1]])])
    return (torch.from_numpy(tile_ptr.astype(np.int32)).to(dev),
            torch.from_numpy(np.concatenate(tiles[::-1]).astype(np.int32)).to(dev),
            len(tiles))


def k2_runs_bitwise(v, shapes, loc, attn, g):
    """K2 twice and once more with `reversed_tables`: raises unless all three
    runs give the same bits in every gradient. Returns the first run."""
    from bm2f_tpu_torch.ops import deform_attn

    first = deform_attn.ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
    second = deform_attn.ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
    tables = reversed_tables(shapes, loc.shape[1], v.device)
    with mock.patch.object(deform_attn, "_device_plan", lambda *a: tables):
        rev = deform_attn.ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("d_value", "d_loc", "d_attn"), first, second, rev):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"K2's {name} differs between runs or tile orders")
    return first


def check_k2(dev, gen):
    """Phase 7: K2 against the closed-form plain backward on K1's edge cases
    and the train-path shapes, each as `k2_runs_bitwise` runs it. Returns
    (max abs error over the three gradients at the train shapes, the
    train-shape inputs)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_plain

    S_train = sum(h * w for h, w in TRAIN_SHAPES)
    cases = [
        (2, ((1, 7), (5, 1), (4, 6)), 777, (-0.2, 1.2)),
        (1, ((1, 1), (3, 9)), 1001, (-0.2, 1.2)),
        (TRAIN_BATCH, TRAIN_SHAPES, S_train, None),
    ]
    for B, shapes, Q, rng in cases:
        v, loc, attn = deform_inputs(B, shapes, Q, gen, dev, rng)
        g = torch.randn(B, Q, M * D, generator=gen).to(dev)
        first = k2_runs_bitwise(v, shapes, loc, attn, g)
        want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
        errs = {}
        for name, a, w in zip(GRAD_TOL, first, want):
            torch.testing.assert_close(a, w, msg=name, **GRAD_TOL[name])
            errs[name] = (a - w).abs().max().item()
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
        share_of_bound=f"{bound / k_ms:.3f}")
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

    from bm2f_tpu_torch.ops.pairwise_cost import log_same_sum_cuda

    for fn in (ms_deform_attn_cuda, ms_deform_attn_bwd_cuda, row_gather_sum_cuda,
               row_gather_sum_onehot_cuda):
        fn.launches = fn.launches_bf16 = 0
    log_same_sum_cuda.launches = 0


def serve(pred, images, path: str, draws: list = None) -> list:
    """`pred` answers `images`, each request ending in a synchronise; checks
    the outputs' shapes and values, the visualization (H, 3W, 3) uint8
    included. Returns the latencies in ms (the drawing, host time,
    included); `draws`, when given, receives each request's drawing in ms."""
    latencies, draw_ms = [], []
    visualize = pred.visualize

    def timed_visualize(image, out):
        t = time.perf_counter()
        vis = visualize(image, out)
        draw_ms.append((time.perf_counter() - t) * 1e3)
        return vis

    pred.visualize = timed_visualize
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
        vis = out["visualization"]
        if vis.shape != (H, 3 * W, 3) or vis.dtype != np.uint8:
            raise AssertionError(f"visualization {vis.shape} {vis.dtype} bad")
    del pred.visualize
    for img, ms, dms in zip(images, latencies, draw_ms):
        log("request", path=path, size="x".join(map(str, img.shape[:2])),
            latency_ms=f"{ms:.2f}", draw_ms=f"{dms:.2f}")
    if draws is not None:
        draws.extend(draw_ms)
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


def make_trainer(dev, over=None):
    """The full-width trainer at its seeded init, with the deformable
    projections perturbed (general sampling locations, not a grid);
    `over`: config overrides."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config(CONFIG, over or {}), device=dev, seed=0)
    perturb_deformable(trainer.model)
    return trainer


def train_path(trainer, dev, config=CONFIG):
    """Phase 10 (and 36): the trainer's step at full width. Returns the
    launch counts of K1 and K2 over the timed steps."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.train.trainer import StageTimer, synthetic_batch

    t0 = time.perf_counter()
    batch = synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=0,
                            device=dev)
    trainer.step(batch)  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    log("train_setup", config=config, batch=TRAIN_BATCH, size=TRAIN_SIZE,
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


def grad_parity(trainer, dev, state: str, per_param: bool = True):
    """Phases 9, 11 and 36: one B=1 1024x1024 loss and every parameter's
    gradient on the same weights, batch and random points, five ways:
      A  K1 forward, K2 backward (the train path); A2 the same again
      C  K1 forward, the closed-form plain backward
      D  the plain forward, the closed-form plain backward
      B  autograd of the plain forward (deform_impl="plain")
    A-A2 is the noise of a rerun (cuDNN's backward), A-C K2's arithmetic inside the model, C-D the
    forward (K1 against the plain einsum), D-B the closed form against
    autograd, A-B the whole. Also counts the samples whose corners moved
    between A's and D's forward, the importance selections and assignments
    that differ, and holds K2 against an f64 backward layer by layer. At
    the init, A-B is held per parameter (`per_param`, R50) or, as phase 32
    holds the video step, on all gradients together (Swin-L, whose bias
    tables' small gradients move by 1e-3 of themselves when a few corners
    move and an importance point changes)."""
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
    whole = rel_err(torch.cat([g.reshape(-1) for g in run["A"][1]]),
                    torch.cat([g.reshape(-1) for g in run["B"][1]]))
    log("grad_parity", state=state, loss_kernel=f"{loss_a:.6f}", loss_plain=f"{loss_b:.6f}",
        params=len(names), whole_path=f"{whole:.3e}",
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
    if state.startswith("init") and not per_param and not whole <= 1e-3:
        raise AssertionError(f"all gradients: |g_kernel - g_plain| / |g_plain| = {whole}")
    if state.startswith("init") and per_param:
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


# phase 12b: (Q, H, W, kernel_size, dilation) of the box cell (864 x 1408 at
# stride 4), a shape that is no multiple of the 16 x 32 tile, and (5, 2)
PAIRWISE_CASES = ((100, 216, 352, 3, 2), (100, 213, 349, 3, 2), (16, 213, 349, 5, 2))


def check_pairwise_cost(dev):
    """Phase 12b: the pairwise sums S through the kernel against
    `weaksup.log_same_sum` (rtol and atol 1e-5: same-sign log-probability
    terms, each an exp and a log within an ulp or two), two launches
    bitwise equal, and at the box cell's shape the kernel, the plain
    version and the whole `pairwise_cost_matrix` timed (the matcher's
    call: G 100, 7 real boxes). Bound: the logits and similarity read
    once, S written once. Returns (max abs err, ms, plain ms, cost ms,
    bound ms, bound by)."""
    from bm2f_tpu_torch.losses import weaksup as tw
    from bm2f_tpu_torch.ops.pairwise_cost import log_same_sum_cuda

    rng = np.random.RandomState(0)
    max_err = 0.0
    for Q, H, W, ks, dil in PAIRWISE_CASES:
        x = torch.from_numpy(rng.randn(Q, H, W).astype(np.float32) * 3)
        x[torch.from_numpy(rng.rand(Q, H, W) < 0.2)] = 40.0
        x[torch.from_numpy(rng.rand(Q, H, W) < 0.2)] = -40.0
        lab = np.repeat(np.repeat(rng.rand(1, -(-H // 8), -(-W // 8), 3) * 100, 8, 1), 8, 2)
        lab = torch.from_numpy((lab[:, :H, :W] + rng.randn(1, H, W, 3)).astype(np.float32))
        cs = tw.get_images_color_similarity(lab, ks, dil)[0].to(dev)
        x = x.to(dev)
        kw = dict(color_thresh=0.3, kernel_size=ks, dilation=dil)
        got = log_same_sum_cuda(x, cs, **kw)
        again = log_same_sum_cuda(x, cs, **kw)
        torch.cuda.synchronize()
        want = tw.log_same_sum(x, cs, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if not torch.equal(got, again):
            raise AssertionError(f"pairwise sums differ between two launches at {Q, H, W}")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        log("check", kernel="pairwise_lsp_sum", Q=Q, H=H, W=W, kernel_size=ks, dilation=dil,
            max_abs_err=f"{err:.3e}")
        if (Q, H, W, ks) == PAIRWISE_CASES[0][:4]:
            box = torch.zeros(100, H, W, device=dev)
            for g in range(7):
                y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 20)
                box[g, y0:y0 + rng.randint(10, H - y0), x0:x0 + rng.randint(10, W - x0)] = 1
            k_ms = cuda_ms(lambda: log_same_sum_cuda(x, cs, **kw), 200)
            p_ms = cuda_ms(lambda: tw.log_same_sum(x, cs, **kw), 10)
            c_ms = cuda_ms(lambda: tw.pairwise_cost_matrix(x, cs, box, **kw), 100)
            n_bytes = (2 * Q * H * W + H * W * cs.shape[-1]) * 4
            # each edge: 7 adds, an exp and a log; each pixel: two log-sigmoids
            bound, by = bound_ms(n_bytes, Q * H * W * (9 * cs.shape[-1] + 6))
            timed = (k_ms, p_ms, c_ms, bound, by)
            log("time", kernel="pairwise_lsp_sum", Q=Q, H=H, W=W, ms=f"{k_ms:.4f}",
                plain_ms=f"{p_ms:.4f}", pairwise_cost_matrix_ms=f"{c_ms:.4f}",
                bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes,
                share_of_bound=f"{bound / k_ms:.3f}")
    return (max_err, *timed)


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
    K1's edge cases and the train-path shapes, each as `k2_runs_bitwise`
    runs it, then timed at the train shapes beside the plain version, the
    bound and the bf16 grid_sample composite's backward. Returns (max abs
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
        first = k2_runs_bitwise(v, shapes, loc, attn, g)
        want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
        if first[0].dtype != torch.bfloat16:
            raise AssertionError(f"d_value came back {first[0].dtype}, not bf16")
        scale = want[0].float().abs().max().item()
        errs = {}
        for name, a, w in zip(GRAD_TOL, first, want):
            a, w = a.float(), w.float()
            if name == "d_value":
                torch.testing.assert_close(a, w, msg=name, rtol=BF16_D_VALUE_RTOL,
                                           atol=BF16_D_VALUE_ATOL_OF_MAX * scale)
            else:
                torch.testing.assert_close(a, w, msg=name, **GRAD_TOL[name])
            errs[name] = (a - w).abs().max().item()
        log("check_bwd", kernel="ms_deform_attn_bwd_bf16", case="edge" if rng else "train",
            B=B, shapes=shapes, Q=Q, d_value_max=f"{scale:.3e}",
            **{f"{k}_max_abs_err": f"{e:.3e}" for k, e in errs.items()})
    L = len(TRAIN_SHAPES)
    k_ms = cuda_ms(lambda: ms_deform_attn_bwd_cuda(v, TRAIN_SHAPES, loc, attn, g), 20)
    p_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(v, TRAIN_SHAPES, loc, attn, g), 3)
    leaves = [t.clone().requires_grad_(True) for t in (v, loc, attn)]
    out = grid_sample_composite(leaves[0], TRAIN_SHAPES, leaves[1], leaves[2])
    gs_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 3)
    del out, leaves
    bound, by, n_bytes, flops = deform_bwd_bound_ms(B, TRAIN_SHAPES, Q, L, loc, value_bytes=2)
    log("time", kernel="ms_deform_attn_bwd_bf16", B=B, tiles=n_tiles(TRAIN_SHAPES, Q, True),
        ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", grid_sample_composite_bwd_ms=f"{gs_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes, flops=flops,
        share_of_bound=f"{bound / k_ms:.3f}")
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


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_batches(dev, n: int) -> list:
    """Phase 10's global batches (B=2, 1024x1024, 8 targets), seeds 0..n-1."""
    from bm2f_tpu_torch.train.trainer import synthetic_batch

    return [synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=i, device=dev)
            for i in range(n)]


def _steps(trainer, batches) -> tuple:
    """Each batch's step: (metrics as floats, host-clock ms to a synchronise)."""
    metrics, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics.append({k: v.item() for k, v in trainer.step(b).items()})
        ms.append((time.perf_counter() - t) * 1e3)
    return metrics, ms


def ddp_world1(dev):
    """Phase G1: `parallel.init_distributed` starts a world-1 NCCL group
    (the variables `torch.distributed.run` sets, for one rank); the trainer
    it builds is wrapped in DDP with the summing hook. Its 3 steps must end
    bitwise equal to 3 steps of the plain trainer from the same seed on the
    same batches (metrics and the whole state). Returns K1's and K2's
    launches over the DDP steps."""
    import os

    import torch.distributed as dist

    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.parallel import init_distributed

    batches = ddp_batches(dev, DDP_STEPS)
    plain = make_trainer(dev)
    want, plain_ms = _steps(plain, batches)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rank_dev = init_distributed("cuda")
        backend = dist.get_backend()
        trainer = make_trainer(rank_dev)
        wrapped = type(trainer.forward).__name__
        reset_counts()
        got, ddp_ms = _steps(trainer, batches)
        launches = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n_layers = len(trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers)
    bad = _same_state(trainer.state_dict(), plain.state_dict())
    log("ddp_world1", backend=backend, device=str(rank_dev), module=wrapped,
        k1_launches=launches[0], k2_launches=launches[1],
        total_loss=",".join(f"{m['total_loss']:.6f}" for m in got),
        grad_norm=",".join(f"{m['grad_norm']:.6f}" for m in got),
        ddp_step_ms=",".join(f"{v:.2f}" for v in ddp_ms),
        plain_step_ms=",".join(f"{v:.2f}" for v in plain_ms), differing_state=len(bad))
    if backend != "nccl" or wrapped != "DistributedDataParallel":
        raise AssertionError(f"G1 ran on {backend} with {wrapped}")
    if launches != (n_layers * DDP_STEPS,) * 2:
        raise AssertionError(f"G1: K1, K2 launched {launches} times in {DDP_STEPS} steps")
    if got != want or bad:
        raise AssertionError(f"G1 differs from the plain trainer: metrics equal "
                             f"{got == want}, state {bad[:8]}")
    return launches


def g2_rank(rank: int, port: int, out_dir: str, device: str, queue) -> None:
    """One of phase G2's two ranks, a spawned process on the card: a gloo
    group started here (the package never picks gloo on the card), the
    trainer DDP-wrapped, G2_STEPS steps on its row of each global batch.
    Rank 0 saves the parameters after the first step; each rank checks
    that its parameters equal rank 0's bit for bit after every step."""
    import traceback

    import torch.distributed as dist

    try:
        sys.path.insert(0, str(ROOT))
        from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
        from bm2f_tpu_torch.parallel import local_rows

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2)
        trainer = make_trainer(dev)
        batches = [local_rows(b) for b in ddp_batches(dev, G2_STEPS)]
        reset_counts()
        metrics, equal, step_ms = [], [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append({k: v.item() for k, v in trainer.step(b).items()})
            step_ms.append((time.perf_counter() - t0) * 1e3)
            flat = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()])
            other = flat.clone()
            dist.broadcast(other, src=0)
            equal.append(torch.equal(flat, other))
            if i == 0 and rank == 0:
                torch.save({n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                           Path(out_dir) / "g2_step1.pt")
        queue.put((rank, {"metrics": metrics, "equal_to_rank0": equal, "step_ms": step_ms,
                          "launches": (ms_deform_attn_cuda.launches,
                                       ms_deform_attn_bwd_cuda.launches),
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def adam_update_bound(g, lr_eff: float, rel: float, ulp):
    """The largest |update_a - update_b| of AdamW's first update, per
    element, when the clipped gradient `g` (f64) of two sides differs by
    `rel` of its tensor's norm plus `rel` of itself: lr_eff (g / (|g| +
    eps)) moves by lr_eff eps |dg| / (|g| + eps)^2, at most the 2 lr_eff of
    a flipped sign; plus the f32 arithmetic of the update (some seven
    roundings of values up to lr_eff, 4 ulp of lr_eff) and an ulp of the new
    parameter, on each side."""
    ag = g.abs()
    tau = rel * (g.norm() + ag)
    return (lr_eff * torch.clamp(1e-8 * tau / (ag + 1e-8) ** 2, max=2.0)
            + 8 * 2.0 ** -23 * lr_eff + 2 * ulp)


def ddp_two_ranks_gloo(dev):
    """Phase G2: two processes on the one card in a gloo group, each one
    image of the global B=2 batch, against the one process's steps on the
    global batch: the first step's losses and grad_norm within G2_REL, its
    update within `adam_update_bound`, the second step's total loss within
    what the first update's differences move it by, both ranks' parameters
    bitwise equal, K1 and K2 6 launches a step on each rank. Returns the
    two ranks' launches summed."""
    import multiprocessing as mp

    plain = make_trainer(dev)
    batches = ddp_batches(dev, G2_STEPS)
    want, plain_ms = _steps(plain, batches[:1])
    ref = {n: p.detach().cpu().clone() for n, p in plain.model.named_parameters()}
    grads = {n: p.grad.detach().cpu().double() for n, p in plain.model.named_parameters()}
    lr = plain.optimizer.schedule(0)
    mults = {g.name: g.lr_mult for g in plain.optimizer.groups}
    clip_max = plain.optimizer.cfg.clip_gradients
    more, ms = _steps(plain, batches[1:])
    want += more
    plain_ms += ms
    # the second step's gradient, at the plain side's parameters after the first
    grads2 = {n: p.grad.detach().cpu().double() for n, p in plain.model.named_parameters()}
    del plain
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_g2_", dir=ROOT / "output")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    device = "cuda:0" if dev.type == "cuda" else str(dev)
    procs = [ctx.Process(target=g2_rank, args=(r, port, out_dir, device, queue))
             for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = dict(queue.get(timeout=600) for _ in procs)
        got1 = torch.load(Path(out_dir) / "g2_step1.pt", weights_only=True)
    finally:
        for proc in procs:
            proc.join(timeout=120)
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    for r in (0, 1):
        if isinstance(got[r], str):
            raise AssertionError(f"G2 rank {r} failed:\n{got[r]}")
    r0, r1 = got[0], got[1]
    rels = [{k: abs(m[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w}
            for m, w in zip(r0["metrics"], want)]
    worst_keys = [max(r, key=r.get) for r in rels]
    loss_rel = rels[0][worst_keys[0]]
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    clip = clip_max / norm if norm >= clip_max else 1.0
    excess = {}
    for n, w in ref.items():
        o = got1[n]
        ulp = torch.from_numpy(np.spacing(np.maximum(w.abs().numpy(), o.abs().numpy())))
        bound = adam_update_bound(grads[n] * clip, lr * mults[n], G2_REL, ulp.double())
        excess[n] = ((o.double() - w.double()).abs() / bound).max().item()
    worst = max(excess, key=excess.get)
    # the second step starts from parameters the first left apart (within
    # the update bound); to first order its total loss moves by
    # sum_i |dL/dp_i| |dp_i|, held at twice that (the second order) plus
    # the summation order's G2_REL
    moved = sum((grads2[n] * (got1[n].double() - ref[n].double())).abs().sum().item()
                for n in ref)
    total2 = abs(r0["metrics"][1]["total_loss"] - want[1]["total_loss"])
    total2_bound = 2 * moved + G2_REL * abs(want[1]["total_loss"])
    from bm2f_tpu_torch.config import get_config

    n_layers = get_config(CONFIG).model.pixel_decoder.transformer_enc_layers
    log("ddp_two_ranks_gloo", steps=G2_STEPS, wall_s=f"{wall_s:.2f}",
        step_ms=",".join(f"{v:.2f}" for v in r0["step_ms"]),
        plain_step_ms=",".join(f"{v:.2f}" for v in plain_ms),
        max_rel_by_step=",".join(f"{k}:{r[k]:.3e}" for k, r in zip(worst_keys, rels)),
        worst_update_excess=f"{excess[worst]:.3e}",
        step2_total_diff=f"{total2:.3e}", step2_total_bound=f"{total2_bound:.3e}",
        worst_param=worst, ranks_bitwise=r0["equal_to_rank0"] + r1["equal_to_rank0"],
        launches=[r0["launches"], r1["launches"]],
        peak_gib=",".join(f"{g['peak_gib']:.2f}" for g in (r0, r1)),
        total_loss=",".join(f"{m['total_loss']:.6f}" for m in r0["metrics"]))
    if r0["metrics"] != r1["metrics"] or not all(r0["equal_to_rank0"] + r1["equal_to_rank0"]):
        raise AssertionError("G2: the two ranks' metrics or parameters differ")
    if not (loss_rel <= G2_REL and excess[worst] <= 1.0 and total2 <= total2_bound):
        raise AssertionError(f"G2 against one process: first step's losses {loss_rel:.3e} "
                             f"(limit {G2_REL}), update {worst} {excess[worst]:.3e} of its "
                             f"bound, second step's total loss {total2:.3e} (limit "
                             f"{total2_bound:.3e})")
    for g in (r0, r1):
        if tuple(g["launches"]) != (n_layers * G2_STEPS,) * 2:
            raise AssertionError(f"G2: K1, K2 launched {g['launches']} on a rank")
    return tuple(a + b for a, b in zip(r0["launches"], r1["launches"]))


def tp_kernels(dev, gen):
    """Phase T1: K1 and K2 at a rank's share of the deformable heads (M/T =
    4 and 2, D = 32) at the train shapes (B=2, 1024x1024): each against its
    plain version, K2 run as `k2_runs_bitwise` runs it, both timed beside
    the plain versions and their bounds (which scale with M). Returns
    {heads: {"fwd": row, "bwd": row}}."""
    from bm2f_tpu_torch.ops.deform_attn import (
        ms_deform_attn_bwd_cuda,
        ms_deform_attn_bwd_plain,
        ms_deform_attn_cuda,
        ms_deform_attn_plain,
    )

    B, shapes, L = TRAIN_BATCH, TRAIN_SHAPES, len(TRAIN_SHAPES)
    S = sum(h * w for h, w in shapes)
    v8, loc8, attn8 = deform_inputs(B, shapes, S, gen, dev)
    g8 = torch.randn(B, S, M, D, generator=gen).to(dev)
    rows = {}
    for T in (2, 4):
        heads = M // T
        v, loc, attn, g = (t[:, :, :heads].contiguous() for t in (v8, loc8, attn8, g8))
        g = g.reshape(B, S, heads * D)
        out = ms_deform_attn_cuda(v, shapes, loc, attn)
        torch.cuda.synchronize()
        f_err = (out - ms_deform_attn_plain(v, shapes, loc, attn)).abs().max().item()
        if not f_err <= 1e-4:
            raise AssertionError(f"T1: K1 at M={heads}: max abs err {f_err} > 1e-4")
        first = k2_runs_bitwise(v, shapes, loc, attn, g)
        want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
        errs = {}
        for name, a, w in zip(GRAD_TOL, first, want):
            torch.testing.assert_close(a, w, msg=f"T1 M={heads} {name}", **GRAD_TOL[name])
            errs[name] = (a - w).abs().max().item()
        del first, want, out
        f_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, shapes, loc, attn), 20)
        fp_ms = cuda_ms(lambda: ms_deform_attn_plain(v, shapes, loc, attn), 3)
        b_ms = cuda_ms(lambda: ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g), 20)
        bp_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(v, shapes, loc, attn, g), 3)
        f_bound, f_by, _, _ = deform_bound_ms(B, shapes, S, L, loc, M=heads)
        b_bound, b_by, _, _ = deform_bwd_bound_ms(B, shapes, S, L, loc, M=heads)
        rows[heads] = {
            "fwd": {"M": heads, "T": T, "max_abs_err": f_err, "ms": f_ms, "plain_ms": fp_ms,
                    "bound_ms": f_bound, "bound_by": f_by},
            "bwd": {"M": heads, "T": T, "max_abs_err": max(errs.values()), "ms": b_ms,
                    "plain_ms": bp_ms, "bound_ms": b_bound, "bound_by": b_by}}
        log("tp_kernels", M=heads, T=T, B=B, Q=S, fwd_max_abs_err=f"{f_err:.3e}",
            **{f"bwd_{k}_max_abs_err": f"{e:.3e}" for k, e in errs.items()},
            fwd_ms=f"{f_ms:.4f}", fwd_plain_ms=f"{fp_ms:.4f}", fwd_bound_ms=f"{f_bound:.4f}",
            bwd_ms=f"{b_ms:.4f}", bwd_plain_ms=f"{bp_ms:.4f}", bwd_bound_ms=f"{b_bound:.4f}",
            k2_bitwise_runs=3)
        del v, loc, attn, g
    del v8, loc8, attn8, g8
    return rows


def t2_rank(rank: int, port: int, out_dir: str, device: str, queue) -> None:
    """One of phase T2's two ranks, a spawned process on the card: a gloo
    group started here, a trainer at mesh (data 1, model 2), so that each
    rank trains the whole global batch on its share of the wide parameters,
    T2_STEPS steps with K1's and K2's head counts recorded, the replicated
    parameters compared with rank 0's after each step; then a checkpoint
    (written by rank 0, the gathered state) and one more step."""
    import traceback

    import torch.distributed as dist

    try:
        sys.path.insert(0, str(ROOT))
        from bm2f_tpu_torch.ops import deform_attn
        from bm2f_tpu_torch.parallel import tp as tparallel
        from bm2f_tpu_torch.train.checkpoint import Checkpointer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=TP_MODEL)
        trainer = make_trainer(dev, {"mesh.model": TP_MODEL})
        batches = ddp_batches(dev, T2_STEPS + 1)
        heads = {"fwd": [], "bwd": []}
        watch = [_watch(deform_attn, "ms_deform_attn_cuda", heads["fwd"],
                        lambda a, o: a[0].shape[2]),
                 _watch(deform_attn, "ms_deform_attn_bwd_cuda", heads["bwd"],
                        lambda a, o: a[0].shape[2])]
        metrics, equal, step_ms = [], [], []
        with watch[0], watch[1]:
            k1, k2 = deform_attn.ms_deform_attn_cuda, deform_attn.ms_deform_attn_bwd_cuda
            k1.launches = k2.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            for i, b in enumerate(batches[:T2_STEPS]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics.append({k: v.item() for k, v in trainer.step(b).items()})
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rep = torch.cat([p.detach().reshape(-1) for n, p
                                 in trainer.model.named_parameters() if n not in trainer.splits])
                other = rep.clone()
                dist.broadcast(other, src=0)
                equal.append(torch.equal(rep, other))
                if i == 0:
                    whole = tparallel.gather_state(
                        {n: p.detach() for n, p in trainer.model.named_parameters()},
                        trainer.splits, trainer.shard)
                    if rank == 0:
                        torch.save({n: t.cpu() for n, t in whole.items()},
                                   Path(out_dir) / "t2_step1.pt")
                    del whole
            launches = (k1.launches, k2.launches)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
        nbytes = {"params": sum(p.numel() * p.element_size()
                                for p in trainer.optimizer.params),
                  "mu": sum(t.numel() * t.element_size() for t in trainer.optimizer.mu),
                  "nu": sum(t.numel() * t.element_size() for t in trainer.optimizer.nu)}
        Checkpointer(Path(out_dir) / "ckpt").save(trainer.step_count, trainer)
        after = {k: v.item() for k, v in trainer.step(batches[T2_STEPS]).items()}
        queue.put((rank, {"metrics": metrics, "equal_to_rank0": equal, "step_ms": step_ms,
                          "launches": launches, "heads": {k: sorted(set(v))
                                                          for k, v in heads.items()},
                          "bytes": nbytes, "peak_gib": peak, "after": after}))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_two_ranks_gloo(dev):
    """Phases T2 and T3: two processes on the one card in a gloo group at
    mesh (data 1, model 2) against one process on the same global B=2
    batches and random points (both draw the global batch's from seed 0):
    the first step's losses and grad_norm within G2_REL, its update within
    `adam_update_bound`, the replicated parameters bitwise equal across the
    ranks after every step, K1 and K2 6 launches a step on each rank, all
    on M/2 heads, each rank's parameter and moment bytes the rules' count.
    T3: the ranks' checkpoint resumed by one process, its state bitwise the
    file's, and its next step against the ranks' within G2_REL (losses)
    and RESUME_GRAD_NORM_RTOL (grad_norm). Returns the two ranks' K1 and K2
    launches summed."""
    import multiprocessing as mp

    from bm2f_tpu_torch.parallel import tp as tparallel
    from bm2f_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer

    plain = make_trainer(dev)
    n_shard, shard_bytes, total_bytes = tparallel.count_sharded(plain.model, TP_MODEL)
    want_bytes = total_bytes - shard_bytes * (TP_MODEL - 1) // TP_MODEL
    batches = ddp_batches(dev, T2_STEPS + 1)
    want, plain_ms = _steps(plain, batches[:1])
    ref = {n: p.detach().cpu().clone() for n, p in plain.model.named_parameters()}
    grads = {n: p.grad.detach().cpu().double() for n, p in plain.model.named_parameters()}
    lr = plain.optimizer.schedule(0)
    mults = {g.name: g.lr_mult for g in plain.optimizer.groups}
    clip_max = plain.optimizer.cfg.clip_gradients
    del plain
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_t2_", dir=ROOT / "output")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    device = "cuda:0" if dev.type == "cuda" else str(dev)
    procs = [ctx.Process(target=t2_rank, args=(r, port, out_dir, device, queue))
             for r in range(TP_MODEL)]
    for proc in procs:
        proc.start()
    try:
        got = dict(queue.get(timeout=900) for _ in procs)
        for r in got:
            if isinstance(got[r], str):
                raise AssertionError(f"T2 rank {r} failed:\n{got[r]}")
        wall_s = time.perf_counter() - t0
        got1 = torch.load(Path(out_dir) / "t2_step1.pt", weights_only=True)
        # -- T3: the checkpoint resumed by one process
        ckpt = Checkpointer(Path(out_dir) / "ckpt")
        saved = torch.load(ckpt.directory / str(ckpt.latest_step()) / STATE_FILE,
                           map_location=dev, weights_only=True)
        saved["generator"] = saved["generator"].cpu()
        fresh = make_trainer(dev)
        step = ckpt.resume_or_load(fresh, resume=True)
        bad = _same_state(fresh.state_dict(), saved)
        del saved
        resumed = {k: v.item() for k, v in fresh.step(batches[T2_STEPS]).items()}
        del fresh
    finally:
        for proc in procs:
            proc.join(timeout=120)
            if proc.is_alive():
                proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    r0, r1 = got[0], got[1]
    rels = {k: abs(r0["metrics"][0][k] - w) / max(abs(w), 1e-12) for k, w in want[0].items()}
    worst_key = max(rels, key=rels.get)
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
    clip = clip_max / norm if norm >= clip_max else 1.0
    excess = {}
    for n, w in ref.items():
        o = got1[n]
        ulp = torch.from_numpy(np.spacing(np.maximum(w.abs().numpy(), o.abs().numpy())))
        bound = adam_update_bound(grads[n] * clip, lr * mults[n], G2_REL, ulp.double())
        excess[n] = ((o.double() - w.double()).abs() / bound).max().item()
    worst = max(excess, key=excess.get)
    after = r0["after"]
    t3_loss = max(abs(resumed[k] - after[k]) / max(abs(after[k]), 1e-12)
                  for k in after if k != "grad_norm")
    t3_norm = abs(resumed["grad_norm"] - after["grad_norm"]) / after["grad_norm"]
    from bm2f_tpu_torch.config import get_config

    n_layers = get_config(CONFIG).model.pixel_decoder.transformer_enc_layers
    log("tp_two_ranks_gloo", mesh=f"(1,{TP_MODEL})", steps=T2_STEPS, wall_s=f"{wall_s:.2f}",
        step_ms=",".join(f"{v:.2f}" for v in r0["step_ms"]),
        step_ms_rank1=",".join(f"{v:.2f}" for v in r1["step_ms"]),
        plain_step_ms=",".join(f"{v:.2f}" for v in plain_ms),
        max_rel=f"{worst_key}:{rels[worst_key]:.3e}",
        worst_update_excess=f"{excess[worst]:.3e}", worst_param=worst,
        replicated_bitwise=r0["equal_to_rank0"] + r1["equal_to_rank0"],
        launches=[r0["launches"], r1["launches"]], heads=[r0["heads"], r1["heads"]],
        sharded_leaves=n_shard, param_bytes_by_rank=[g["bytes"]["params"] for g in (r0, r1)],
        param_bytes_rule=want_bytes, replicated_param_bytes=total_bytes,
        peak_gib=",".join(f"{g['peak_gib']:.2f}" for g in (r0, r1)),
        total_loss=",".join(f"{m['total_loss']:.6f}" for m in r0["metrics"]))
    log("tp_resume_one_process", step=step, differing_state=len(bad),
        next_total_loss=f"{resumed['total_loss']:.6f}", max_loss_rel=f"{t3_loss:.3e}",
        grad_norm_rel=f"{t3_norm:.3e}")
    if r0["metrics"] != r1["metrics"] or not all(r0["equal_to_rank0"] + r1["equal_to_rank0"]):
        raise AssertionError("T2: the ranks' metrics or replicated parameters differ")
    if not (rels[worst_key] <= G2_REL and excess[worst] <= 1.0):
        raise AssertionError(f"T2 against one process: losses {rels[worst_key]:.3e} (limit "
                             f"{G2_REL}), update {worst} {excess[worst]:.3e} of its bound")
    for g in (r0, r1):
        if tuple(g["launches"]) != (n_layers * T2_STEPS,) * 2:
            raise AssertionError(f"T2: K1, K2 launched {g['launches']} on a rank")
        if g["heads"] != {"fwd": [M // TP_MODEL], "bwd": [M // TP_MODEL]}:
            raise AssertionError(f"T2: the kernels ran on {g['heads']} heads")
        if any(v != want_bytes for v in g["bytes"].values()):
            raise AssertionError(f"T2: a rank holds {g['bytes']} bytes, the rules "
                                 f"{want_bytes} each")
    if step != T2_STEPS or bad:
        raise AssertionError(f"T3: resumed at {step}; differing from the file: {bad[:8]}")
    if not (t3_loss <= G2_REL and t3_norm <= RESUME_GRAD_NORM_RTOL):
        raise AssertionError(f"T3: the resumed step against the ranks': losses {t3_loss:.3e} "
                             f"(limit {G2_REL}), grad_norm {t3_norm:.3e} (limit "
                             f"{RESUME_GRAD_NORM_RTOL})")
    return tuple(a + b for a, b in zip(r0["launches"], r1["launches"]))


def write_eval_dataset(out_dir: Path):
    """Phase 19: the synthetic dataset under a new directory of `out_dir`,
    registered. Returns (its root, {dataset: evaluator type})."""
    from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
    from bm2f_tpu_torch.data.synthetic import COCO_SIZES, write_synthetic_coco

    root = tempfile.mkdtemp(prefix="chip_smoke_data_", dir=out_dir)
    t0 = time.perf_counter()
    names = write_synthetic_coco(root, seed=0)
    register_all_builtin_datasets(root, force=True)
    log("eval_data", root=root, datasets=",".join(f"{k}:{v}" for k, v in names.items()),
        sizes=" ".join(f"{h}x{w}" for h, w in COCO_SIZES),
        seconds=f"{time.perf_counter() - t0:.2f}")
    return root, names


def eval_path():
    """Phase 20: `run_eval` in each of EVAL_RUNS. Returns ({run: K1 launches
    (f32, bf16)}, {run: metrics}, {dtype: Predictor})."""
    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    preds, launches, metrics = {}, {}, {}
    for run, dataset, over in EVAL_RUNS:
        dtype = "bf16" if over else "f32"
        if dtype not in preds:
            preds[dtype] = Predictor()
            preds[dtype].setup(CONFIG, device="cuda", seed=0, overrides=over)
            perturb_deformable(preds[dtype].model)  # the weights of phase 5
        pred = preds[dtype]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timings = []
        t0 = time.perf_counter()
        res = port_eval.run_eval(pred.cfg, pred.model, dataset, timings=timings)
        wall = time.perf_counter() - t0
        n = len(timings)
        launches[run] = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
        want = (0, 6 * n) if over else (6 * n, 0)
        n_images = len(DatasetCatalog.get(dataset))
        if n != n_images or launches[run] != want:
            raise AssertionError(f"eval {run}: {n} images, K1 f32, bf16 launches "
                                 f"{launches[run]}, expected {n_images} and {want}")
        bad = {k: v for k, v in res.items() if not 0.0 <= float(v) <= 100.0}
        if bad:
            raise AssertionError(f"eval {run}: metrics out of [0, 100]: {bad}")
        metrics[run] = res
        by_bucket = {}
        for t in timings:
            by_bucket.setdefault(t["bucket"], []).append(t["ms"])
        warm = [ms for v in by_bucket.values() for ms in v[1:]]
        log("eval", run=run, dataset=dataset, images=n,
            metrics=" ".join(f"{k}={float(v):.4f}" for k, v in res.items()),
            warm_images_per_s=f"{1e3 * len(warm) / sum(warm):.3f}",
            **{f"b{b}_first_ms": f"{v[0]:.2f}" for b, v in sorted(by_bucket.items())},
            **{f"b{b}_warm_ms": "/".join(f"{ms:.2f}" for ms in v[1:])
               for b, v in sorted(by_bucket.items())},
            k1_launches_per_image=f"{sum(launches[run]) / n:.1f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            wall_s=f"{wall:.2f}")
    return launches, metrics, preds


def gt_oracle():
    """Phase 21: each evaluator fed the ground truth as predictions (crowd
    regions left out of the instance predictions: they are ignored)."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
    from bm2f_tpu_torch.data.panoptic_io import read_panoptic_png
    from bm2f_tpu_torch.eval import load_sem_gt
    from bm2f_tpu_torch.evaluation import (
        COCOMaskAPEvaluator,
        PanopticEvaluator,
        SemSegEvaluator,
    )

    K = get_config(CONFIG).model.num_classes
    coco = COCOMaskAPEvaluator(K)
    for dd in DatasetCatalog.get("coco_2017_val"):
        anns = dd["annotations"]
        masks = np.stack([segmentation_to_mask(a["segmentation"], dd["height"], dd["width"])
                          for a in anns]).astype(bool)
        labels = np.asarray([a["category_id"] for a in anns], np.int64)
        crowd = np.asarray([bool(a["iscrowd"]) for a in anns])
        coco.process({"scores": np.ones(int((~crowd).sum())), "labels": labels[~crowd],
                      "masks": masks[~crowd]},
                     {"labels": labels, "masks": masks, "iscrowd": crowd})
    sem = SemSegEvaluator(K, ignore_label=255)
    for dd in DatasetCatalog.get("ade20k_sem_seg_val"):
        gt = load_sem_gt(dd)
        sem.process(gt.copy(), gt)
    name = "coco_2017_val_panoptic"
    dicts = DatasetCatalog.get(name)
    things = set(MetadataCatalog.get(name).thing_dataset_id_to_contiguous_id.values())
    pan = PanopticEvaluator(K, tuple(c in things for c in range(K)))
    for dd in dicts:
        gt_map = read_panoptic_png(dd["pan_seg_file_name"]).astype(np.int64) - 1
        segs = [{"id": s["id"] - 1, "category_id": s["category_id"],
                 "iscrowd": s["iscrowd"]} for s in dd["segments_info"]]
        pan.process(gt_map.copy(), [{k: s[k] for k in ("id", "category_id")} for s in segs],
                    gt_map, segs)
    got = {"AP": coco.evaluate()["AP"], "mIoU": sem.evaluate()["mIoU"],
           "PQ": pan.evaluate()["PQ"]}
    log("eval_oracle", **{k: repr(float(v)) for k, v in got.items()})
    if any(float(v) != 100.0 for v in got.values()):
        raise AssertionError(f"the ground truth as predictions scored {got}, not 100")


def eval_image(cfg, dd) -> np.ndarray:
    """One dataset image as the eval feeds it: resized and padded to its
    bucket by the eval's mapper."""
    from bm2f_tpu_torch.data.mappers import EvalMapper
    from bm2f_tpu_torch.eval import bucket_ladder

    return EvalMapper(short_edge=cfg.input.min_size_test, max_size=cfg.input.max_size_test,
                      bucket=bucket_ladder(cfg.input.max_size_test),
                      pad_value=cfg.model.pixel_mean)(dd)["images"]


def check_k1_eval_buckets(pred):
    """Phase 22: K1 and K1-bf16 at B=1 on the eval buckets, on the first
    encoder layer's inputs of one synthetic image in each (through the
    eval's mapper and forward), against the plain version, and timed beside
    it and the bound. Returns {(bucket, dtype): row}."""
    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.models import pixel_decoder
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain

    cfg = pred.cfg
    dicts = DatasetCatalog.get("coco_2017_val")
    rows = {}
    for bucket, index in EVAL_BUCKETS.items():
        images = eval_image(cfg, dicts[index])
        if images.shape[0] != bucket:
            raise AssertionError(f"image {index} went to bucket {images.shape[0]}, not {bucket}")
        calls = []
        with _watch(pixel_decoder, "ms_deform_attn", calls, lambda a, o: a):
            port_eval._forward(cfg, pred.model, images[None])
        v32, shapes, loc, attn = calls[0]
        Q = loc.shape[1]
        for dtype, v in (("f32", v32), ("bf16", v32.to(torch.bfloat16))):
            got = ms_deform_attn_cuda(v, shapes, loc, attn)
            torch.cuda.synchronize()
            want = ms_deform_attn_plain(v, shapes, loc, attn)
            err = (got - want).abs().max().item()
            # each output sums 48 weighted samples in another order (phase 3;
            # in bf16 the f32 arithmetic on the same bf16 rows, phase 13)
            if not err <= (1e-4 if dtype == "f32" else 1e-5 + 1e-5 * want.abs().max().item()):
                raise AssertionError(f"K1 {dtype} at bucket {bucket}: max abs err {err}")
            k_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, shapes, loc, attn), 50)
            p_ms = cuda_ms(lambda: ms_deform_attn_plain(v, shapes, loc, attn), 5)
            bound, by, n_bytes, flops = deform_bound_ms(
                1, shapes, Q, len(shapes), loc, value_bytes=2 if dtype == "bf16" else 4)
            rows[(bucket, dtype)] = {"shapes": [list(hw) for hw in shapes], "Q": Q,
                                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                                     "bound_ms": bound, "bound_by": by}
            log("time", kernel=f"ms_deform_attn_fwd{'_bf16' if dtype == 'bf16' else ''}",
                case=f"eval_bucket_{bucket}", B=1, Q=Q, max_abs_err=f"{err:.3e}",
                ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound:.4f}",
                bound_by=by, bytes=n_bytes, flops=flops, share_of_bound=f"{bound / k_ms:.3f}")
        del calls, v32, loc, attn
    return rows


def weights_round_trip(pred, data_root: str):
    """Phase 23: the f32 eval model through the port's checkpoint and
    `--weights`; the orbax reader's named error where tensorstore is
    missing."""
    import importlib.util
    import os

    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.train.checkpoint import Checkpointer
    from bm2f_tpu_torch.utils.convert_weights import load_weights

    out_dir = ROOT / "output"
    directory = tempfile.mkdtemp(prefix="chip_smoke_weights_", dir=out_dir)
    try:
        Checkpointer(directory).save_state(0, {"step": 0, "model": pred.model.state_dict()})
        loaded = Predictor()
        loaded.setup(CONFIG, directory, device="cuda")
        cfg = pred.cfg
        images = eval_image(cfg, DatasetCatalog.get("coco_2017_val")[0])[None]
        a = port_eval._forward(cfg, pred.model, images)
        b = port_eval._forward(cfg, loaded.model, images)
        differ = [k for k in ("pred_logits", "pred_masks") if not torch.equal(a[k], b[k])]
        del a, b, loaded
        os.environ["DETECTRON2_DATASETS"] = data_root
        via_cli = port_eval.main(["--config", CONFIG, "--dataset", "coco_2017_val",
                                  "--weights", directory, "--max-images", "2"])
        direct = port_eval.run_eval(cfg, pred.model, "coco_2017_val", max_images=2)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if differ or via_cli != direct:
        raise AssertionError(f"weights round trip: {differ} differ; metrics {via_cli} "
                             f"through --weights against {direct}")
    orbax = "tensorstore installed: not exercised here"
    if importlib.util.find_spec("tensorstore") is None:
        fake = Path(tempfile.mkdtemp(prefix="chip_smoke_orbax_", dir=out_dir))
        try:
            (fake / "0" / "default").mkdir(parents=True)
            (fake / "0" / "default" / "_METADATA").write_text(json.dumps(
                {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": False}))
            load_weights(str(fake), pred.cfg)
            raise AssertionError("the orbax reader ran without tensorstore")
        except ImportError as e:
            if "tensorstore" not in str(e):
                raise
            orbax = f"ImportError naming tensorstore ({str(e)[:60]}...)"
        finally:
            shutil.rmtree(fake, ignore_errors=True)
    log("weights", predictions="bitwise equal", metrics_via_weights=repr(via_cli),
        orbax_reader=repr(orbax))


def weak_batches(cfg, dev, n: int) -> list:
    """`n` batches of phase 19's `coco_2017_val` split through the config's
    mapper and `build_train_loader`, on the card."""
    from bm2f_tpu_torch.data import build_train_loader
    from bm2f_tpu_torch.data.mappers import MAPPERS
    from bm2f_tpu_torch.train.loop import to_device

    mapper = MAPPERS[cfg.input.dataset_mapper](cfg.input, seed=cfg.train.seed)
    loader = build_train_loader("coco_2017_val", mapper, cfg.train.ims_per_batch,
                                seed=cfg.train.seed)
    return [to_device(next(loader), dev) for _ in range(n)]


def make_weak_trainer(config, dev, seed=0, over=None):
    """A full-width trainer of `config` with `over` (WEAK_OVER when None),
    deformable projections perturbed as `make_trainer`'s."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config(config, WEAK_OVER if over is None else over), device=dev,
                      seed=seed)
    perturb_deformable(trainer.model)
    return trainer


def weak_train_path(trainer, batches, dev, path: str, tag: str = "weak",
                    nonzero=("loss_mask_projection", "loss_pairwise")):
    """Phase 24 (and 31, with tag "video" and the video losses in
    `nonzero`): one warm-up step on batches[0], then a timed step on each
    of the others, every count set to 0 just before and read just after; a
    weak step's `nonzero` losses must be > 0. Returns (K1, K2 launches over
    the timed steps, the median step ms)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.train.trainer import StageTimer

    t0 = time.perf_counter()
    trainer.step(batches[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    (b, g), (h, w) = batches[0]["masks"].shape[:2], batches[0]["masks"].shape[-2:]
    log(f"{tag}_setup", path=path, sup_type=trainer.cfg.model.loss.sup_type, batch=b,
        targets=g, canvas=f"{h}x{w}",
        valid_targets=int(sum(x["valid"].sum().item() for x in batches[1:])),
        seconds=f"{time.perf_counter() - t0:.2f}")
    if g != trainer.cfg.input.max_instances:
        raise AssertionError(f"targets padded to {g}, not input.max_instances")
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer(dev)
    reset_counts()
    step_ms, weak = [], trainer.cfg.model.loss.sup_type != "mask"
    for i, batch in enumerate(batches[1:]):
        timer.start()
        t = time.perf_counter()
        metrics = {k: v.item() for k, v in trainer.step(batch, mark=timer).items()}
        step_ms.append((time.perf_counter() - t) * 1e3)
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{path} step {i}: non-finite {bad}")
        final = {k: f"{v:.4f}" for k, v in metrics.items()
                 if k.startswith("loss_") and not k.rsplit("_", 1)[-1].isdigit()}
        log(f"{tag}_step", path=path, step=i, total_loss=f"{metrics['total_loss']:.4f}",
            **final, grad_norm=f"{metrics['grad_norm']:.4f}", step_ms=f"{step_ms[-1]:.2f}")
        zero = [k for k in nonzero if weak and not metrics[k] > 0]
        if zero:
            raise AssertionError(f"{path} step {i}: {zero} zero")
    n_steps = len(batches) - 1
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_bwd_cuda.launches)
    bf16_launches = (ms_deform_attn_cuda.launches_bf16, ms_deform_attn_bwd_cuda.launches_bf16)
    layers = trainer.model.sem_seg_head.pixel_decoder.transformer.encoder.layers
    if launches != (len(layers) * n_steps,) * 2 or bf16_launches != (0, 0):
        raise AssertionError(f"{path}: K1, K2 launched {launches} times in {n_steps} steps, "
                             f"expected {len(layers) * n_steps} each, and on a bf16 value "
                             f"{bf16_launches}, expected none")
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = {}
    for i, layer in enumerate(layers):
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            gw = getattr(layer.self_attn, name).weight.grad
            grads[f"{i}.{name}"] = 0.0 if gw is None else gw.abs().sum().item()
    zero = [k for k, v in grads.items() if not v > 0]
    if zero:
        raise AssertionError(f"{path}: no gradient reached encoder projections {zero}")
    median = statistics.median(step_ms)
    log(f"{tag}_main", path=path, k1_launches=launches[0], k2_launches=launches[1],
        step_ms=" ".join(f"{v:.2f}" for v in step_ms), step_ms_median=f"{median:.2f}",
        peak_mem_gib=f"{peak:.2f}", min_encoder_grad_abs_sum=f"{min(grads.values()):.3e}")
    log(f"{tag}_stages", path=path, **{k: f"{v / n_steps:.2f}ms" for k, v in timer.ms.items()})
    return launches, median


def pairwise_launches(path: str) -> int:
    """The pairwise-sum kernel's launches in the timed weak steps just run
    (`weak_train_path` sets the counts to 0 before them): at least one, as
    every weak preset here takes the pairwise cost."""
    from bm2f_tpu_torch.ops.pairwise_cost import log_same_sum_cuda

    n = log_same_sum_cuda.launches
    log("pairwise", path=path, launches=n)
    if n < 1:
        raise AssertionError(f"{path}: the pairwise-sum kernel never launched")
    return n


def weak_parity(trainer, batch, dev):
    """Phase 25, first part: the weak loss and every parameter's gradient
    through K1 + K2 against the plain path (deform_impl="plain") on the same
    weights and batch: loss rtol 1e-4, each gradient within a norm-relative
    1e-3 (`grad_parity`'s tolerances at the init). The weak criterion draws
    no random points; the assignments are counted apart."""
    names, params = zip(*trainer.model.named_parameters())
    res = {}
    for impl in ("auto", "plain"):
        asg = []
        with _watch(trainer, "assign_fn", asg, lambda a, o: o):
            total, losses = trainer.loss(batch, deform_impl=impl)
            grads = torch.autograd.grad(total, params)
        res[impl] = (total.item(), grads, asg[0], {k: v.item() for k, v in losses.items()})
    (lk, gk, ak, mk), (lp, gp, ap, mp) = res["auto"], res["plain"]
    rel = [rel_err(a, b) for a, b in zip(gk, gp)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    log("weak_parity", loss_kernel=f"{lk:.6f}", loss_plain=f"{lp:.6f}",
        loss_rel=f"{abs(lk - lp) / abs(lp):.3e}", params=len(names),
        worst=f"{rel[worst]:.3e}@{names[worst]}",
        loss_pairwise=f"{mk['loss_pairwise']:.6f}/{mp['loss_pairwise']:.6f}",
        assignments_differing=int((ak != ap).sum()))
    if not (mk["loss_pairwise"] > 0 and mk["loss_mask_projection"] > 0):
        raise AssertionError(f"weak losses zero at parity: {mk}")
    if not abs(lk - lp) <= 1e-4 * abs(lp):
        raise AssertionError(f"weak loss through the kernels {lk} vs plain {lp}")
    bad = [(n, r) for n, r in zip(names, rel) if not r <= 1e-3]
    if bad:
        raise AssertionError(f"weak gradients, kernel against plain: {bad[:5]}")


def weak_repeats(batches, dev, config=WEAK_CONFIG, over=None):
    """Phase 25 (and 32), second part: two trainers of `config` from one
    seed, two weak steps each (the second with the pairwise warmup at 1),
    end with the same bits in every parameter, buffer and moment."""
    states = []
    for _ in range(2):
        trainer = make_weak_trainer(config, dev, over=over)
        for batch in batches[:2]:
            trainer.step(batch)
        torch.cuda.synchronize()
        states.append(trainer.state_dict())
        del trainer
    bad = _same_state(*states)
    log("weak_repeat", config=config, steps=2, state_keys=len(states[0]["model"]),
        differing=len(bad))
    if bad:
        raise AssertionError(f"two weak steps from one seed differ in {bad[:8]}")


def entry_point_run(data_root: str, distributed: bool = False):
    """Phase 26: the train entry point as a subprocess on the card, trained
    and evaluated on phase 19's split, then `--eval-only --resume`; with
    `distributed` (phase G3) both runs as the one rank of `python -m
    torch.distributed.run --nproc-per-node 1 ... --distributed` (NCCL).
    Returns its wall seconds."""
    from bm2f_tpu_torch.train.checkpoint import Checkpointer

    out = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=ROOT / "output")
    base = ["--config", ENTRY_CONFIG,
            "--dataset", "coco_2017_val", "--data-root", data_root, "--output", out,
            "--set", "train.ims_per_batch=2", "--set", f"train.eval_period={ENTRY_PERIOD}",
            "--set", f"train.checkpoint_period={ENTRY_PERIOD}"]

    def run(extra):
        launch = [sys.executable, "-m", "bm2f_tpu_torch.train"]
        if distributed:
            launch = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
                      "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
                      "-m", "bm2f_tpu_torch.train", "--distributed"]
        t0 = time.perf_counter()
        res = subprocess.run(launch + base + extra, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{' '.join(extra)}: exit {res.returncode}\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        return res.stdout, time.perf_counter() - t0

    try:
        stdout, train_s = run(["--eval-dataset", "coco_2017_val",
                               "--max-iter", str(ENTRY_ITERS)])
        lines = [json.loads(ln) for ln in Path(out, "metrics.json").read_text().splitlines()]
        steps = Checkpointer(str(Path(out, "checkpoints"))).all_steps()
        eval_out, eval_s = run(["--eval-only", "--resume"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    at = [ln for ln in lines if ln["iteration"] == ENTRY_PERIOD]
    want = {"total_loss", "loss_ce", "loss_mask_projection", "grad_norm", "eval/AP"}
    if not at or not want <= set(at[0]) or f"training done at iter {ENTRY_ITERS}" not in stdout:
        raise AssertionError(f"metrics.json {lines}; stdout {stdout[-2000:]}")
    if not {ENTRY_PERIOD, ENTRY_ITERS} <= set(steps):
        raise AssertionError(f"checkpoints at {steps}")
    evals = [json.loads(ln[5:]) for ln in eval_out.splitlines() if ln.startswith("eval ")]
    if (f"resumed from step {ENTRY_ITERS}" not in eval_out or not evals
            or evals[0]["iteration"] != ENTRY_ITERS or "eval/AP" not in evals[0]):
        raise AssertionError(f"--eval-only: {eval_out[-2000:]}")
    log("entry_point_distributed" if distributed else "entry_point", config=ENTRY_CONFIG,
        max_iter=ENTRY_ITERS, train_eval_s=f"{train_s:.2f}",
        eval_only_s=f"{eval_s:.2f}", checkpoints=steps,
        metrics_at_2=",".join(sorted(k for k in at[0] if k.startswith("eval/"))),
        eval_only=repr({k: round(v, 3) for k, v in evals[0].items()}))
    return train_s


def write_video_dataset(out_dir: Path):
    """Phase 27: the synthetic YouTube-VIS val and train splits under a new
    directory of `out_dir`, registered. Returns (its root, the DINO grids'
    root)."""
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.synthetic import DINO_GRID, YTVIS_TRAIN_LENGTHS, write_synthetic_ytvis
    from bm2f_tpu_torch.data.ytvis import register_all_ytvis

    out_dir.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_video_", dir=out_dir)
    t0 = time.perf_counter()
    write_synthetic_ytvis(root, "ytvis_2019_val", VIDEO_LENGTHS, seed=0)
    feats_root = write_synthetic_ytvis(root, "ytvis_2021_train", YTVIS_TRAIN_LENGTHS, seed=1,
                                       feats=True)
    register_all_ytvis(root, force=True)
    tracks = {n: sum(len(dd["annotations"]) for dd in DatasetCatalog.get(n))
              for n in ("ytvis_2019_val", "ytvis_2021_train")}
    log("video_data", root=root, val_lengths=VIDEO_LENGTHS, train_lengths=YTVIS_TRAIN_LENGTHS,
        frame_size="1280x720", dino_grid="x".join(map(str, DINO_GRID)), tracks=tracks,
        seconds=f"{time.perf_counter() - t0:.2f}")
    return root, feats_root


def make_video_model():
    """The full-width eval model of VIDEO_CONFIG from seed 0, its deformable
    projections perturbed as phase 5's, weights cast once for inference."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.video import build_video_model

    cfg = get_config(VIDEO_CONFIG)
    model = build_video_model(cfg, device="cuda", seed=0)
    perturb_deformable(model)
    return cfg, model.cast_weights_for_inference_()


def video_eval_path(cfg, model):
    """Phase 28: `run_video_eval` on ytvis_2019_val twice, every count set to
    0 before and read after. Returns (K1 launches, the metrics)."""
    from bm2f_tpu_torch import eval_video
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda

    n_videos = len(DatasetCatalog.get("ytvis_2019_val"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    passes = []
    for _ in range(2):
        timings = []
        t0 = time.perf_counter()
        res = eval_video.run_video_eval(cfg, model, "ytvis_2019_val", timings=timings)
        passes.append((res, timings, time.perf_counter() - t0))
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    n_layers = len(model.sem_seg_head.pixel_decoder.transformer.encoder.layers)  # 6
    if launches != (n_layers * 2 * n_videos, 0):
        raise AssertionError(f"video eval: K1 f32, bf16 launches {launches} for 2 x {n_videos} "
                             f"clips, expected {n_layers * 2 * n_videos} and 0")
    (res, first, wall), (res2, warm, _) = passes
    bad = {k: v for k, v in res.items() if not 0.0 <= float(v) <= 100.0}
    if bad or len(first) != n_videos:
        raise AssertionError(f"video eval: {len(first)} clips, metrics {res}")
    frames = sum(t["T"] for t in warm)
    log("video_eval", config=VIDEO_CONFIG, videos=n_videos,
        metrics=" ".join(f"{k}={float(v):.4f}" for k, v in res.items()),
        second_pass_AP=f"{float(res2['AP']):.4f}",
        warm_frames_per_s=f"{1e3 * frames / sum(t['ms'] for t in warm):.3f}",
        **{f"first_T{t['T']}_Tp{t['frames']}_S{t['size']}_ms": f"{t['ms']:.2f}" for t in first},
        **{f"warm_T{t['T']}_ms": f"{t['ms']:.2f}/load {t['load_ms']:.2f}/predict "
                                 f"{t['predict_ms']:.2f}" for t in warm},
        k1_launches_per_clip=f"{launches[0] / (2 * n_videos):.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        first_pass_wall_s=f"{wall:.2f}")
    return launches[0], res


def video_gt_oracle(cfg):
    """Phase 28, second part: the val split's tracks as predictions (crowd
    tracks left out: they are ignored) score AP 100."""
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
    from bm2f_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator

    ev = YTVISEvaluator(cfg.model.num_classes)
    for dd in DatasetCatalog.get("ytvis_2019_val"):
        h, w = dd["height"], dd["width"]
        masks = np.stack([np.stack([np.zeros((h, w), bool) if sg is None
                                    else segmentation_to_mask(sg, h, w) > 0
                                    for sg in a["segmentations"]]) for a in dd["annotations"]])
        labels = np.asarray([a["category_id"] for a in dd["annotations"]], np.int64)
        crowd = np.asarray([bool(a["iscrowd"]) for a in dd["annotations"]])
        ev.process({"video_id": dd["video_id"], "scores": np.ones(int((~crowd).sum())),
                    "labels": labels[~crowd], "masks": masks[~crowd]},
                   {"labels": labels, "masks": masks, "iscrowd": crowd})
    ap = ev.evaluate()["AP"]
    log("video_eval_oracle", AP=repr(float(ap)))
    if float(ap) != 100.0:
        raise AssertionError(f"the ground-truth tracks as predictions scored AP {ap}, not 100")


def video_clip(cfg, index: int):
    """Video `index` of ytvis_2019_val as the eval feeds it: (clip, frame
    mask, its length)."""
    from bm2f_tpu_torch import eval_video
    from bm2f_tpu_torch.data import DatasetCatalog

    dd = DatasetCatalog.get("ytvis_2019_val")[index]
    short, top = cfg.input.min_size_test, cfg.input.max_size_test
    clip, fv, _ = eval_video.prepare_clip(dd, dd["length"], short, top,
                                          eval_video.spatial_buckets(short, top))
    return clip, fv, dd["length"]


def video_forward(cfg, model, clip, fv=None):
    """The video model on a clip of raw pixels (and its frame mask), as
    `eval_video.predict_clip` runs it: normalized, in f32, no gradient."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.utils.precision import f32_scope

    dev = next(model.parameters()).device
    x = normalize_images(torch.from_numpy(np.ascontiguousarray(clip)).to(dev), cfg.model)
    with torch.no_grad(), f32_scope(cfg.model.dtype):
        return model(x, None if fv is None else torch.from_numpy(fv).to(dev))


def video_padding_parity(cfg, model):
    """Phase 29: the 5-frame clip at its true length (no frame mask) against
    the same clip padded to its 8-frame bucket with `frame_valid`: logits and
    the masks of its frames within the forward's card tolerance (phase 6)."""
    clip, fv, T = video_clip(cfg, 0)
    true = video_forward(cfg, model, clip[:, :T])
    pad = video_forward(cfg, model, clip, fv)
    diffs = {}
    for key, a, b in (("pred_logits", pad["pred_logits"], true["pred_logits"]),
                      ("pred_masks", pad["pred_masks"][:, :, :T], true["pred_masks"])):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1.5e-3)
        diffs[key] = (a - b).abs().max().item()
    log("video_padding", T=T, Tp=clip.shape[1], S=clip.shape[2],
        **{f"{k}_max_abs_diff": f"{v:.3e}" for k, v in diffs.items()})


def video_k1_rows(cfg, model):
    """Phase 30, K1: at the eval's Tp = 8 and 40 buckets (S = 640), on the
    first encoder layer's inputs of a clip of each (`k1_row`). Returns
    {Tp: row}."""
    rows = {}
    for index, length in enumerate(VIDEO_LENGTHS):
        clip, fv, _ = video_clip(cfg, index)
        Tp, S = clip.shape[1:3]
        if Tp not in VIDEO_K1_FRAMES:
            continue
        inputs = first_layer_inputs(lambda: video_forward(cfg, model, clip, fv))
        rows[Tp] = {"frames": Tp, "S": S,
                    **k1_row(*inputs, case=f"video_eval_Tp{Tp}_S{S}")}
        del inputs
        torch.cuda.empty_cache()
    if sorted(rows) != sorted(VIDEO_K1_FRAMES):
        raise AssertionError(f"K1 video rows at {sorted(rows)}, not {VIDEO_K1_FRAMES}")
    return rows


def video_k2_row(dev):
    """Phase 30, K2: at the shapes of a video train step (2 clips x 2 frames
    at 512x512: B*T = 4 frames, levels 16, 32, 64), on the bench's
    encoder-like inputs (as phase 7's train case) and a seeded grad_out,
    against the closed-form plain backward, bitwise across runs and tile
    orders, timed beside it and the bound. Returns its row."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_bwd_plain

    cfg = get_config(VIDEO_MASK_CONFIG, VIDEO_OVER)
    size, B = cfg.input.image_size, cfg.train.ims_per_batch * cfg.input.sampling_frame_num
    shapes = tuple((size // s, size // s) for s in (32, 16, 8))
    Q, L = sum(h * w for h, w in shapes), len(shapes)
    gen = torch.Generator().manual_seed(5)
    v, loc, attn = deform_inputs(B, shapes, Q, gen, dev)
    g = torch.randn(B, Q, M * D, generator=gen).to(dev)
    first = k2_runs_bitwise(v, shapes, loc, attn, g)
    want = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
    errs = {}
    for name, a, w in zip(GRAD_TOL, first, want):
        errs[name] = (a - w).abs().max().item()
        torch.testing.assert_close(a, w, msg=f"{name}: max abs err {errs[name]:.3e}",
                                   **GRAD_TOL[name])
    del first, want
    k_ms = cuda_ms(lambda: ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g), 20)
    p_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(v, shapes, loc, attn, g), 3)
    bound, by, n_bytes, flops = deform_bwd_bound_ms(B, shapes, Q, L, loc)
    log("time", kernel="ms_deform_attn_bwd", case="video_train", B=B, Q=Q,
        tiles=n_tiles(shapes, Q, True),
        **{f"{k}_max_abs_err": f"{e:.3e}" for k, e in errs.items()}, ms=f"{k_ms:.4f}",
        plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes,
        flops=flops, share_of_bound=f"{bound / k_ms:.3f}")
    return {"frames": B, "shapes": [list(hw) for hw in shapes], "Q": Q,
            "max_abs_err": max(errs.values()), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by}


def video_k2_against_f64(trainer, batch, dev):
    """Phase 31, before the timed steps: K2 on the first encoder layer's own
    inputs of a video batch (a seeded grad_out) and the closed-form plain
    backward in f32, each against the plain backward in f64 on the same
    corners. Where the frames hold flat colours, a few d_loc elements are
    small differences of large terms, so K2 and the plain f32 backward may
    differ beyond GRAD_TOL there: each is held to the f64 backward instead,
    K2 within twice the plain f32 backward's own error."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_bwd_plain

    v, shapes, loc, attn = first_layer_inputs(
        lambda: trainer.model(normalize_images(batch["images"], trainer.cfg.model)))
    g = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * v.shape[3],
                    generator=torch.Generator().manual_seed(5)).to(dev)
    k2 = ms_deform_attn_bwd_cuda(v, shapes, loc, attn, g)
    plain = ms_deform_attn_bwd_plain(v, shapes, loc, attn, g)
    ref = ms_deform_attn_bwd_plain(v.double(), shapes, loc, attn.double(), g.double())
    fields, bad = {}, []
    for name, a, p, r in zip(GRAD_TOL, k2, plain, ref):
        tol = GRAD_TOL[name]
        e_k, e_p = (a.double() - r).abs().max().item(), (p.double() - r).abs().max().item()
        beyond = int(((a - p).abs() > tol["atol"] + tol["rtol"] * p.abs()).sum())
        fields[name] = f"k2_f64={e_k:.3e} plain_f64={e_p:.3e} beyond_grad_tol={beyond}"
        if not e_k <= 2 * e_p + 1e-7:
            bad.append(name)
    log("video_k2_f64", B=v.shape[0], Q=loc.shape[1],
        **{k: repr(v_) for k, v_ in fields.items()})
    if bad:
        raise AssertionError(f"K2 on a video batch's inputs, against f64: {bad} beyond twice "
                             "the plain f32 backward's error")


def video_batches(config, dev, n: int, feats_root: str) -> list:
    """`n` batches of phase 27's ytvis_2021_train split through the mapper
    the train entry point picks for `config` (`ytvis_with_feats`, with the
    synthetic DINO grids' root, for the temporal pairwise loss) and
    `build_train_loader`, on the card."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.data import build_train_loader
    from bm2f_tpu_torch.data.mappers import MAPPERS
    from bm2f_tpu_torch.train.loop import to_device

    cfg = get_config(config, VIDEO_OVER)
    if "temporal_pairwise" in cfg.model.loss.sup_type:
        mapper = MAPPERS["ytvis_with_feats"](cfg.input, seed=cfg.train.seed,
                                             feats_root=feats_root)
    else:
        mapper = MAPPERS[cfg.input.dataset_mapper](cfg.input, seed=cfg.train.seed)
    loader = build_train_loader("ytvis_2021_train", mapper, cfg.train.ims_per_batch,
                                seed=cfg.train.seed)
    return [to_device(next(loader), dev) for _ in range(n)]


def video_weak_parity(trainer, batch):
    """Phase 32, first part: the weak video loss and every parameter's
    gradient three ways on the same weights and batch, as
    tests/test_torch_cuda.py's weak test: K1 + K2 (A), K1 + the closed-form
    plain backward (C), the plain deformable path (B). A-C (K2 against the
    plain backward on the same forward): each gradient within a
    norm-relative SAME_FORWARD_REL. A-B (the whole path): the loss to rtol
    1e-4 and all gradients together within a norm-relative 1e-3 (K1 and the
    plain forward round apart, which moves a few samples across a
    pixel-centre line; the worst single parameter is logged)."""
    from bm2f_tpu_torch.ops import deform_attn
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_plain

    names, params = zip(*trainer.model.named_parameters())
    res = {}
    for run, impl, bwd in (("A", "auto", None), ("C", "auto", ms_deform_attn_bwd_plain),
                           ("B", "plain", None)):
        asg = []
        with mock.patch.object(deform_attn, "ms_deform_attn_bwd_cuda",
                               bwd or deform_attn.ms_deform_attn_bwd_cuda), \
                _watch(trainer, "assign_fn", asg, lambda a, o: o):
            total, losses = trainer.loss(batch, deform_impl=impl)
            grads = torch.autograd.grad(total, params)
        res[run] = (total.item(), grads, asg[0], {k: v.item() for k, v in losses.items()})
    (la, ga, aa, ma), (_, gc, _, _), (lb, gb, ab, _) = res["A"], res["C"], res["B"]
    same = [rel_err(a, c) for a, c in zip(ga, gc)]
    whole = rel_err(torch.cat([g.reshape(-1) for g in ga]), torch.cat([g.reshape(-1) for g in gb]))
    per = [rel_err(a, b) for a, b in zip(ga, gb)]
    worst = max(range(len(per)), key=per.__getitem__)
    log("video_parity", loss_kernel=f"{la:.6f}", loss_plain=f"{lb:.6f}",
        loss_rel=f"{abs(la - lb) / abs(lb):.3e}", params=len(names),
        same_forward_worst=f"{max(same):.3e}", whole_path=f"{whole:.3e}",
        worst_param=f"{per[worst]:.3e}@{names[worst]}",
        **{k: f"{ma[k]:.6f}" for k in VIDEO_WEAK_LOSSES},
        assignments_differing=int((aa != ab).sum()))
    zero = [k for k in VIDEO_WEAK_LOSSES if not ma[k] > 0]
    if zero:
        raise AssertionError(f"weak video losses zero at parity: {zero}")
    if not abs(la - lb) <= 1e-4 * abs(lb):
        raise AssertionError(f"weak video loss through the kernels {la} vs plain {lb}")
    bad = [(n, r) for n, r in zip(names, same) if not r <= SAME_FORWARD_REL]
    if bad or not whole <= 1e-3:
        raise AssertionError(f"weak video gradients: K2 vs plain backward {bad[:5]}, "
                             f"the whole path {whole:.3e}")


def video_entry_point_run(data_root: str):
    """Phase 33: the train entry point as a subprocess on the card on phase
    27's splits (2 steps, an eval at step 1, a checkpoint at 2), then
    `--eval-only --resume` (the eval at step 2). Returns its wall seconds."""
    from bm2f_tpu_torch.train.checkpoint import Checkpointer

    out = tempfile.mkdtemp(prefix="chip_smoke_video_train_", dir=ROOT / "output")
    base = [sys.executable, "-m", "bm2f_tpu_torch.train", "--config", VIDEO_WEAK_CONFIG,
            "--dataset", "ytvis_2021_train", "--eval-dataset", "ytvis_2019_val",
            "--data-root", data_root, "--output", out,
            "--set", "train.ims_per_batch=2", "--set", "train.eval_period=1",
            "--set", "train.checkpoint_period=2"]

    def run(extra):
        t0 = time.perf_counter()
        res = subprocess.run(base + extra, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{' '.join(extra)}: exit {res.returncode}\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        return res.stdout, res.stderr, time.perf_counter() - t0

    try:
        stdout, stderr, train_s = run(["--max-iter", "2"])
        lines = [json.loads(ln) for ln in Path(out, "metrics.json").read_text().splitlines()]
        steps = Checkpointer(str(Path(out, "checkpoints"))).all_steps()
        eval_out, _, eval_s = run(["--eval-only", "--resume"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    at1 = [ln for ln in lines if ln["iteration"] == 1]
    want = {"total_loss", "loss_mask_projection", "loss_mask_temporal_pairwise",
            "temp_pair_valid_prop", "grad_norm", "eval/AP"}
    if not at1 or not want <= set(at1[-1]) or "training done at iter 2" not in stdout:
        raise AssertionError(f"metrics.json {lines}; stdout {stdout[-2000:]}")
    if "zero DINO features" not in stderr:
        raise AssertionError(f"no zero-features notice in the log: {stderr[-2000:]}")
    if 2 not in steps:
        raise AssertionError(f"checkpoints at {steps}")
    evals = [json.loads(ln[5:]) for ln in eval_out.splitlines() if ln.startswith("eval ")]
    if (not evals or evals[0]["iteration"] != 2 or "eval/AP" not in evals[0]):
        raise AssertionError(f"--eval-only: {eval_out[-2000:]}")
    log("video_entry_point", config=VIDEO_WEAK_CONFIG, max_iter=2,
        train_eval_s=f"{train_s:.2f}", eval_only_s=f"{eval_s:.2f}", checkpoints=steps,
        metrics_at_1=",".join(sorted(k for k in at1[-1] if k.startswith("eval/"))),
        eval_only=repr({k: round(v, 3) for k, v in evals[0].items()}))
    return train_s


def k1_row(v, shapes, loc, attn, case: str) -> dict:
    """K1 on one encoder layer's own inputs against the plain version (each
    output sums 48 weighted samples in another order: 1e-4), timed beside it
    and the bound. Returns its row."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain

    B, Q = v.shape[0], loc.shape[1]
    got = ms_deform_attn_cuda(v, shapes, loc, attn)
    torch.cuda.synchronize()
    want = ms_deform_attn_plain(v, shapes, loc, attn)
    err = (got - want).abs().max().item()
    del got, want
    if not err <= 1e-4:
        raise AssertionError(f"K1 at {case}: max abs err {err}")
    k_ms = cuda_ms(lambda: ms_deform_attn_cuda(v, shapes, loc, attn), 20)
    p_ms = cuda_ms(lambda: ms_deform_attn_plain(v, shapes, loc, attn), 3)
    bound, by, n_bytes, flops = deform_bound_ms(B, shapes, Q, len(shapes), loc)
    log("time", kernel="ms_deform_attn_fwd", case=case, B=B, Q=Q, max_abs_err=f"{err:.3e}",
        ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
        bytes=n_bytes, flops=flops, share_of_bound=f"{bound / k_ms:.3f}")
    return {"B": B, "shapes": [list(hw) for hw in shapes], "Q": Q, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by}


def first_layer_inputs(run):
    """The first encoder layer's (value, shapes, locations, weights) as
    `run()` hands them to the deformable attention."""
    from bm2f_tpu_torch.models import pixel_decoder

    calls = []
    with _watch(pixel_decoder, "ms_deform_attn", calls,
                lambda a, o: (a[0].detach(), a[1], a[2].detach(), a[3].detach())), \
            torch.no_grad():
        run()
    return calls[0]


def video_padding_stages(cfg, model):
    """Phase 29, second part: the 5-frame clip at its true length (batch 5)
    and padded to its 8-frame bucket (batch 8), stage by stage: the
    backbone's four levels and the pixel decoder's outputs on the valid
    frames, once with cuDNN as the eval runs it and once with one algorithm
    forced (benchmark off, deterministic on). Then the decoder alone on
    those outputs, in f32 and with the decoder in f64: (a) the true-length
    clip with no frame mask against the same clip with an all-valid mask
    (the f64 temporal table against the masked f32 one), (b) that against
    the padded clip (the padding alone). In f64, (b) must vanish
    (PAD_F64_ABS): padded frames that leaked into the valid ones would show
    there at any precision."""
    import copy

    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.utils.precision import f32_scope

    clip, fv, T = video_clip(cfg, 0)
    dev = next(model.parameters()).device
    x = normalize_images(torch.from_numpy(np.ascontiguousarray(clip)).to(dev), cfg.model)
    head = model.sem_seg_head
    cudnn = torch.backends.cudnn

    def encode(frames):
        B, Tn = frames.shape[:2]
        feats = model.backbone(frames.flatten(0, 1).permute(0, 3, 1, 2).contiguous())
        mf, _, ms = head.pixel_decoder(feats)
        return ({**feats, **{f"pd_level{i}": f for i, f in enumerate(ms)}, "mask_features": mf},
                ([f.reshape(B, Tn, *f.shape[1:]) for f in ms], mf.reshape(B, Tn, *mf.shape[1:])))

    diffs = {}
    for mode, flags in (("default", (cudnn.benchmark, cudnn.deterministic)),
                        ("one_algorithm", (False, True))):
        with torch.no_grad(), f32_scope(cfg.model.dtype), cudnn.flags(
                enabled=True, benchmark=flags[0], deterministic=flags[1], allow_tf32=False):
            (true_f, true_in), (pad_f, pad_in) = encode(x[:, :T]), encode(x)
        diffs[mode] = {k: ((pad_f[k][:T] - true_f[k]).abs().max().item(),
                           true_f[k].abs().max().item()) for k in true_f}
        log("video_padding_stages", mode=mode, T=T, Tp=clip.shape[1],
            **{k: f"{d:.3e}/{m:.3e}" for k, (d, m) in diffs[mode].items()})

    dec64 = copy.deepcopy(head.predictor).double()
    dec64.dtype = torch.float64
    ones = torch.ones(1, T, dtype=torch.bool, device=dev)
    runs = {"none": (true_in, None), "ones": (true_in, ones),
            "padded": (pad_in, torch.from_numpy(fv).to(dev))}
    for tag, dec, to in (("f32", head.predictor, lambda t: t),
                         ("f64", dec64, lambda t: t.double())):
        with torch.no_grad(), f32_scope(cfg.model.dtype):
            out = {k: dec([to(f) for f in ms], to(mf), mask)
                   for k, ((ms, mf), mask) in runs.items()}
        for k in out:
            out[k]["pred_masks"] = out[k]["pred_masks"][:, :, :T]
        gaps = {f"{pair}_{key}": (out[a][key] - out[b][key]).abs().max().item()
                for pair, a, b in (("table", "none", "ones"), ("padding", "ones", "padded"))
                for key in ("pred_logits", "pred_masks")}
        diffs[f"decoder_{tag}"] = gaps
        log("video_padding_decoder", dtype=tag, **{k: f"{v:.3e}" for k, v in gaps.items()})
    bad = {k: v for k, v in diffs["decoder_f64"].items()
           if k.startswith("padding") and not v <= PAD_F64_ABS}
    if bad:
        raise AssertionError(f"the padded clip departs from its true length in f64: {bad}")
    return diffs


def swin_backbone_f64(dev):
    """Phase 34: the Swin-L backbone of SWIN_CONFIG (seeded) at B=2,
    1024x1024 in f32 on the card against the same backbone in f64 on the
    card, each level norm-relative within SWIN_F64_REL; both timed."""
    import copy

    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models import build_model
    from bm2f_tpu_torch.utils.precision import f32_scope

    backbone = build_model(get_config(SWIN_CONFIG), device=dev, seed=0).backbone
    ref = copy.deepcopy(backbone).double()
    ref.dtype = torch.float64
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(TRAIN_BATCH, 3, TRAIN_SIZE, TRAIN_SIZE, generator=gen).to(dev)
    times = {}
    with torch.no_grad(), f32_scope("float32"):
        for tag, net, inp in (("f32", backbone, x), ("f64", ref, x.double())):
            net(inp)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = net(inp)
            torch.cuda.synchronize()
            times[tag] = ((time.perf_counter() - t) * 1e3,
                          torch.cuda.max_memory_allocated() / 2**30)
            if tag == "f32":
                got = out
            del out
        want = ref(x.double())
    errs = {k: rel_err(got[k], want[k]) for k in want}
    log("swin_f64", config=SWIN_CONFIG, B=TRAIN_BATCH, size=TRAIN_SIZE,
        **{f"{k}_rel": f"{e:.3e}" for k, e in errs.items()},
        **{f"{k}_shape": "x".join(map(str, got[k].shape)) for k in got},
        f32_ms=f"{times['f32'][0]:.2f}", f64_ms=f"{times['f64'][0]:.2f}",
        f32_peak_gib=f"{times['f32'][1]:.2f}", f64_peak_gib=f"{times['f64'][1]:.2f}")
    bad = {k: e for k, e in errs.items() if not e <= SWIN_F64_REL}
    if bad:
        raise AssertionError(f"Swin-L f32 against f64 beyond {SWIN_F64_REL}: {bad}")
    return errs


def swin_serve(images, dev):
    """Phase 35: `Predictor` on SWIN_CONFIG at full width (seeded, the
    deformable projections perturbed as phase 5's) answers the requests
    twice, every count set to 0 before and read after (K1 6 a request, K2
    none): the 800x800 request warm, the 480x640 and 800x1088 ones first at
    their shape the first time, then warm. The stage split, peak memory,
    the kernel path against the plain path, K1 on a request's first-layer
    inputs, and one bf16 request against the f32 kernel path."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    pred = Predictor()
    t0 = time.perf_counter()
    pred.setup(SWIN_CONFIG, device=dev, seed=0)
    perturb_deformable(pred.model)
    torch.cuda.synchronize()
    log("swin_setup", config=SWIN_CONFIG, seconds=f"{time.perf_counter() - t0:.2f}",
        params=sum(p.numel() for p in pred.model.parameters()),
        backbone_params=sum(p.numel() for p in pred.model.backbone.parameters()))
    pred.predict(images[0])  # warm-up at 800x800, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = serve(pred, images, "swin_l_f32_first")
    warm = serve(pred, images, "swin_l_f32_warm")
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16,
                ms_deform_attn_bwd_cuda.launches)
    if launches != (6 * 2 * len(images), 0, 0):
        raise AssertionError(f"Swin-L serving: K1 f32, K1 bf16, K2 launched {launches}, "
                             f"expected {6 * 2 * len(images)}, 0, 0")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("swin_main", launches=launches[0], k2_launches=launches[2],
        peak_mem_gib=f"{peak:.2f}",
        **{f"first_{h}x{w}_ms": f"{a:.2f}" for (h, w), a in zip(REQUESTS, first)},
        **{f"warm_{h}x{w}_ms": f"{b:.2f}" for (h, w), b in zip(REQUESTS, warm)})
    x = stage_split(pred, images[0], "swin_l_f32")
    model = pred.model
    xn = normalize_images(x.to(dev), pred.cfg.model)
    with torch.no_grad():
        a = model(xn)
        b = model(xn, deform_impl="plain")
    for key in ("pred_logits", "pred_masks"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-3, atol=1.5e-3)
        log("swin_parity", key=key, max_abs_diff=f"{(a[key] - b[key]).abs().max().item():.3e}")
    del b
    row = k1_row(*first_layer_inputs(lambda: model(xn)), case="swin_l_serve_800x800")
    del pred, model
    torch.cuda.empty_cache()

    pred16 = Predictor()
    pred16.setup(SWIN_CONFIG, device=dev, seed=0, overrides={"model.dtype": "bfloat16"})
    perturb_deformable(pred16.model)  # the f32 model's weights, in bf16
    bf16_first = serve(pred16, images[:1], "swin_l_bf16_first")[0]
    bf16_warm = serve(pred16, images[:1], "swin_l_bf16_warm")[0]
    with torch.no_grad():
        c = pred16.model(xn)
    rel = {k: rel_err(c[k].float(), a[k]) for k in ("pred_logits", "pred_masks")}
    log("swin_bf16", pixel_decoder_f32=pred16.cfg.model.pixel_decoder_f32,
        first_ms=f"{bf16_first:.2f}", warm_ms=f"{bf16_warm:.2f}",
        **{f"{k}_rel_vs_f32": f"{v:.3e}" for k, v in rel.items()})
    # as phase 14's R50 bound; read on an H100: 7.8e-3 (logits), 1.5e-2 (masks)
    if not max(rel.values()) <= BF16_VS_F32_REL:
        raise AssertionError(f"Swin-L bf16 against f32 beyond {BF16_VS_F32_REL}: {rel}")
    del pred16, a, c
    torch.cuda.empty_cache()
    return launches[0], row


def make_swin_trainer(dev, seed=0):
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.trainer import Trainer

    trainer = Trainer(get_config(SWIN_CONFIG), device=dev, seed=seed)
    perturb_deformable(trainer.model)
    return trainer


def swin_train(dev):
    """Phase 36: `Trainer` on SWIN_CONFIG at full width: gradient parity at
    the seeded init (phase 9's, B=1), then phase 10's train path (B=2,
    1024x1024, 8 targets; K1 and K2 6 launches a step), every Swin stage's
    `qkv` and bias tables reached by the gradient, and two trainers from
    one seed ending two steps with the same bits. Returns the launches."""
    from bm2f_tpu_torch.train.trainer import synthetic_batch

    trainer = make_swin_trainer(dev)
    grad_parity(trainer, dev, "init_swin_l", per_param=False)
    launches = train_path(trainer, dev, SWIN_CONFIG)
    grads = {}
    for s, stage in enumerate(trainer.model.backbone.layers):
        for name in ("qkv.weight", "relative_position_bias_table"):
            g = [blk.attn.get_parameter(name).grad for blk in stage.blocks]
            grads[f"stage{s}_{name.split('.')[0]}"] = min(
                0.0 if x is None else x.abs().sum().item() for x in g)
    zero = [k for k, v in grads.items() if not v > 0]
    log("swin_train_grads", **{k: f"{v:.3e}" for k, v in grads.items()})
    if zero:
        raise AssertionError(f"no gradient reached a block of {zero}")
    del trainer
    torch.cuda.empty_cache()

    batches = [synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=s, device=dev)
               for s in (0, 1)]
    states = []
    for _ in range(2):
        trainer = make_swin_trainer(dev)
        for batch in batches:
            trainer.step(batch)
        torch.cuda.synchronize()
        states.append(trainer.state_dict())
        del trainer
        torch.cuda.empty_cache()
    bad = _same_state(*states)
    log("swin_repeat", config=SWIN_CONFIG, steps=2, state_keys=len(states[0]["model"]),
        differing=len(bad))
    if bad:
        raise AssertionError(f"two Swin-L trainers from one seed differ in {bad[:8]}")
    return launches


def swin_video(dev):
    """Phase 37: `run_video_eval` on SWIN_VIDEO_CONFIG (Swin-L, the 480 test
    size) at full width, on the first clip of phase 27's ytvis_2019_val (5
    frames, its 8-frame bucket) twice, every count set to 0 before and read
    after (K1 6 a clip); the first and the warm clip's time, peak memory,
    and K1 on the clip's first-layer inputs. Returns (K1 launches, row)."""
    from bm2f_tpu_torch import eval_video
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.video import build_video_model

    cfg = get_config(SWIN_VIDEO_CONFIG)
    model = build_video_model(cfg, device=dev, seed=0)
    perturb_deformable(model)
    model.cast_weights_for_inference_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    passes = []
    for _ in range(2):
        timings = []
        res = eval_video.run_video_eval(cfg, model, "ytvis_2019_val", max_videos=1,
                                        timings=timings)
        passes.append((res, timings[0]))
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    if launches != (6 * 2, 0):
        raise AssertionError(f"Swin-L video eval: K1 f32, bf16 launches {launches}, "
                             "expected 12 and 0")
    (res, first), (_, warm) = passes
    if not all(0.0 <= float(v) <= 100.0 for v in res.values()):
        raise AssertionError(f"Swin-L video eval metrics {res}")
    log("swin_video", config=SWIN_VIDEO_CONFIG, short_edge=cfg.input.min_size_test,
        T=first["T"], Tp=first["frames"], S=first["size"],
        first_ms=f"{first['ms']:.2f}", first_predict_ms=f"{first['predict_ms']:.2f}",
        warm_ms=f"{warm['ms']:.2f}", warm_load_ms=f"{warm['load_ms']:.2f}",
        warm_predict_ms=f"{warm['predict_ms']:.2f}", k1_launches_per_clip=launches[0] / 2,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        metrics=" ".join(f"{k}={float(v):.4f}" for k, v in res.items()))
    clip, fv, _ = video_clip(cfg, 0)
    Tp, S = clip.shape[1:3]
    row = k1_row(*first_layer_inputs(lambda: video_forward(cfg, model, clip, fv)),
                 case=f"swin_l_video_Tp{Tp}_S{S}")
    del model
    torch.cuda.empty_cache()
    return launches[0], row

# ---------------------------------------------------------------------------
# Phases A-F: the user entry points and the MaskFormer-v1 models
# ---------------------------------------------------------------------------


def predictor_visualization(dev):
    """Phase A: the `Predictor` with its default config (PANOPTIC_CONFIG,
    133 classes) at full width from seed 0, deformable projections perturbed
    as phase 5's, answers 3 requests at 800x800, each with its visualization
    (H, 3W, 3) uint8; the drawing (host time) timed apart. Then `python -m
    bm2f_tpu_torch.predict` (its `main`, on the card by default) writes one
    request's visualization. Every count is set to 0 just before each part
    and read just after: K1 6 launches a request. Returns K1's launches."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable

    pred = Predictor()
    pred.setup(device=dev, seed=0)
    if pred.cfg.model.num_classes != 133:
        raise AssertionError(f"the Predictor's default config has "
                             f"{pred.cfg.model.num_classes} classes, not "
                             f"{PANOPTIC_CONFIG}'s 133")
    perturb_deformable(pred.model)
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (*REQUESTS[0], 3)).astype(np.uint8) for _ in range(3)]
    pred.predict(images[0])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    draws = []
    latencies = serve(pred, images, "panoptic_visualization", draws)
    launches = ms_deform_attn_cuda.launches
    if (launches, ms_deform_attn_cuda.launches_bf16) != (6 * len(images), 0):
        raise AssertionError(f"predictor: K1 launched {launches} times, expected "
                             f"{6 * len(images)}")
    log("predictor", config=PANOPTIC_CONFIG, requests=len(images), k1_launches=launches,
        latency_ms="/".join(f"{ms:.2f}" for ms in latencies),
        draw_ms="/".join(f"{ms:.2f}" for ms in draws),
        network_and_copies_ms="/".join(f"{a - b:.2f}" for a, b in zip(latencies, draws)),
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del pred
    torch.cuda.empty_cache()

    # the entry point, on the card by default: `python -m bm2f_tpu_torch.predict`
    from PIL import Image

    from bm2f_tpu_torch import predict

    (ROOT / "output").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "output") as tmp:
        src, dst = Path(tmp) / "request.png", Path(tmp) / "prediction.png"
        Image.fromarray(images[0]).save(src)
        reset_counts()
        t0 = time.perf_counter()
        predict.main(["--input", str(src), "--output", str(dst)])
        cli_s = time.perf_counter() - t0
        with Image.open(dst) as im:
            size = im.size
    H, W = images[0].shape[:2]
    if size != (3 * W, H) or ms_deform_attn_cuda.launches != 6:
        raise AssertionError(f"predict CLI: wrote {size}, K1 launched "
                             f"{ms_deform_attn_cuda.launches} times")
    log("predict_cli", config=PANOPTIC_CONFIG, png="x".join(map(str, size)),
        k1_launches=ms_deform_attn_cuda.launches, seconds=f"{cli_s:.2f}")
    return launches + ms_deform_attn_cuda.launches


def demo_path(data_root: str):
    """Phase B: `python -m bm2f_tpu_torch.demo` (its `main`, on the card by
    default) on PANOPTIC_CONFIG over phase 19's images at their native
    sizes: each task at depth 2, writing one PNG an image; then the panoptic
    task at depth 1 and at depth 2 again, the pipeline's wall time against
    the sum of its stages (overlap shows as a depth-2 wall time under depth
    1's). Every count set to 0 just before each run and read just after: K1
    6 launches an image. Returns K1's launches over the five runs."""
    from PIL import Image

    from bm2f_tpu_torch import demo
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda

    images = sorted(str(p) for p in (Path(data_root) / "coco" / "val2017").glob("*.jpg"))
    sizes = {}
    for path in images:
        with Image.open(path) as im:
            sizes[path] = im.size
    out_root = Path(data_root) / "demo_out"
    total, walls = 0, {}
    for i, (task, depth) in enumerate((("instance", 2), ("semantic", 2), ("panoptic", 2),
                                       ("panoptic", 1), ("panoptic", 2))):
        out_dir = out_root / f"{i}_{task}_d{depth}"
        reset_counts()
        res = demo.main(["--config", PANOPTIC_CONFIG, "--input", *images, "--output",
                         str(out_dir), "--task", task, "--depth", str(depth)])
        torch.cuda.synchronize()
        launches = ms_deform_attn_cuda.launches
        want = [str(out_dir / (Path(p).name + ".viz.png")) for p in images]
        if res["written"] != want or launches != 6 * len(images):
            raise AssertionError(f"demo {task}: wrote {len(res['written'])} of "
                                 f"{len(images)}, K1 launched {launches} times")
        for path, png in zip(images, want):
            with Image.open(png) as im:
                if im.size != sizes[path]:
                    raise AssertionError(f"{png}: {im.size}, image {sizes[path]}")
        total += launches
        stage_sum = sum(res["stage_s"].values())
        walls.setdefault(depth, []).append(res["wall_s"])
        log("demo", task=task, depth=depth, images=len(images), k1_launches=launches,
            wall_s=f"{res['wall_s']:.3f}", stage_sum_s=f"{stage_sum:.3f}",
            **{f"{k}_s": f"{v:.3f}" for k, v in res["stage_s"].items()},
            pngs=len(res["written"]))
    log("demo_overlap", task="panoptic", images=len(images),
        depth1_wall_s=f"{walls[1][0]:.3f}",
        depth2_wall_s="/".join(f"{w:.3f}" for w in walls[2][2:]),
        depth2_over_depth1=f"{min(walls[2][2:]) / walls[1][0]:.3f}")
    return total


def demo_video_path(video_root: str):
    """Phase C: `python -m bm2f_tpu_torch.demo_video` (its `main`) on
    VIDEO_CONFIG over phase 27's DEMO_VIDEO_FRAMES-frame clip at its native
    1280x720 (padded to 736x1280, one forward of the whole clip): one PNG a
    frame, the time, the peak memory, K1 6 launches (every count set to 0
    just before and read just after). Returns K1's launches."""
    from PIL import Image

    from bm2f_tpu_torch import demo_video
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda

    dd = next(d for d in DatasetCatalog.get("ytvis_2019_val")
              if d["length"] == DEMO_VIDEO_FRAMES)
    frames = str(Path(dd["file_names"][0]).parent)
    out_dir = Path(video_root) / "demo_video_out"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = demo_video.main(["--config", VIDEO_CONFIG, "--input", frames, "--output",
                           str(out_dir)])
    torch.cuda.synchronize()
    launches = ms_deform_attn_cuda.launches
    if (res["frames"], len(res["written"]), launches) != (DEMO_VIDEO_FRAMES,) * 2 + (6,):
        raise AssertionError(f"demo_video: {res['frames']} frames, "
                             f"{len(res['written'])} written, K1 {launches} launches")
    with Image.open(res["written"][-1]) as im:
        if im.size != (dd["width"], dd["height"]):
            raise AssertionError(f"demo_video frame {im.size}")
    log("demo_video", config=VIDEO_CONFIG, frames=res["frames"],
        native=f"{dd['height']}x{dd['width']}", padded="x".join(map(str, res["padded_hw"])),
        pngs=len(res["written"]), tracks_kept=res["tracks_kept"],
        seconds=f"{res['seconds']:.3f}", k1_launches=launches,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return launches


def tta_path(dev):
    """Phase D: `run_eval(..., tta=True)` of TTA_CONFIG (150 classes, 100
    queries) at full width from seed 0, deformable projections perturbed,
    over the first TTA_IMAGES images of phase 19's ade20k_sem_seg_val, each
    at its original size: TTA_FORWARDS forwards an image (scales 0.5-1.75,
    each flipped), K1 72 launches an image (counts set to 0 just before and
    read just after); images/s and peak memory. Then one image's averaged
    probabilities through K1 against the plain path, within the forward's
    f32 error: FWD_EPS = 1.5e-3 + 1e-3 max|output| (tests/test_torch_tta.py;
    a probability moves by at most its logits' error, an average and a
    bilinear resize by no more). Returns K1's launches."""
    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.mappers import read_image
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.models.tta import semantic_tta
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.utils.precision import f32_scope

    pred = Predictor()
    pred.setup(TTA_CONFIG, device=dev, seed=0)
    perturb_deformable(pred.model)
    cfg, model = pred.cfg, pred.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timings = []
    t0 = time.perf_counter()
    res = port_eval.run_eval(cfg, model, "ade20k_sem_seg_val", max_images=TTA_IMAGES,
                             tta=True, timings=timings)
    wall = time.perf_counter() - t0
    launches = ms_deform_attn_cuda.launches
    if len(timings) != TTA_IMAGES or launches != 6 * TTA_FORWARDS * TTA_IMAGES:
        raise AssertionError(f"tta: {len(timings)} images, K1 {launches} launches, "
                             f"expected {6 * TTA_FORWARDS * TTA_IMAGES}")
    if not 0.0 <= float(res["mIoU"]) <= 100.0:
        raise AssertionError(f"tta: mIoU {res['mIoU']}")
    log("tta", config=TTA_CONFIG, images=len(timings), mIoU=f"{float(res['mIoU']):.4f}",
        sizes=" ".join("x".join(map(str, t["hw"])) for t in timings),
        image_ms="/".join(f"{t['ms']:.2f}" for t in timings),
        images_per_s=f"{len(timings) / sum(t['ms'] / 1e3 for t in timings):.3f}",
        warm_images_per_s=f"{(len(timings) - 1) / sum(t['ms'] / 1e3 for t in timings[1:]):.3f}",
        k1_launches=launches, k1_per_image=launches // len(timings),
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        wall_s=f"{wall:.2f}")

    img = read_image(DatasetCatalog.get("ade20k_sem_seg_val")[TTA_IMAGES - 1]["file_name"])
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
    scale = []

    def predictor(impl):
        def predict(v):
            out = model(normalize_images(v, cfg.model), deform_impl=impl)
            scale.append(max(out["pred_logits"].abs().max().item(),
                             out["pred_masks"].abs().max().item()))
            return out["pred_logits"], out["pred_masks"]
        return predict

    with torch.no_grad(), f32_scope(cfg.model.dtype):
        a = semantic_tta(predictor("auto"), x)
        b = semantic_tta(predictor("plain"), x)
    err = (a - b).abs().max().item()
    eps = 1.5e-3 + 1e-3 * max(scale)
    log("tta_parity", size="x".join(map(str, img.shape[:2])), forwards=len(scale),
        max_abs_diff=f"{err:.3e}", bound=f"{eps:.3e}",
        argmax_moved=int((a.argmax(-1) != b.argmax(-1)).sum().item()))
    if not err <= eps:
        raise AssertionError(f"tta: the kernel path's probabilities {err} from the plain "
                             f"path's, beyond {eps}")
    del pred, model, a, b
    torch.cuda.empty_cache()
    return launches


def oom_retry_path(dev):
    """Phase E: `retry_if_oom` forced on the card. An eval batch of
    OOM_BATCH images at the OOM_BUCKET bucket (the loader's, from phase 19's
    coco_2017_val) runs uncapped, then its half; the process is capped
    (`torch.cuda.set_per_process_memory_fraction`) at the memory it keeps
    plus a share of the half's peak, lowered in steps (OOM_HALF_SHARES) until
    the batch runs out of memory while its halves fit. The capped forward
    splits (`retry_if_oom.splits` > 0) and equals the uncapped one
    within the forward's f32 tolerance (rtol 1e-3 / atol 1.5e-3, phase 6);
    `run_eval` at OOM_BATCH images a batch gives the same AP under that cap
    (its forwards and its restored masks halved as they need) as without.
    Under a cap that one image cannot fit, the forward raises at batch 1.
    The cap is lifted after. Returns K1's launches in the capped forward."""
    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.utils.memory import retry_if_oom

    pred = Predictor()
    pred.setup(CONFIG, device=dev, seed=0)
    perturb_deformable(pred.model)
    cfg, model = pred.cfg, pred.model
    loader = port_eval._build_loader(cfg, "coco_2017_val", cfg.input.min_size_test,
                                     cfg.input.max_size_test, (OOM_BUCKET,),
                                     batch_size=OOM_BATCH)
    images = next(iter(loader))["images"]

    uncapped = port_eval.run_eval(cfg, model, "coco_2017_val", ims_per_batch=OOM_BATCH)

    def forward_peak(n):
        """The forward's peak above what was allocated before it, and its
        outputs on the host (kept on the card they could pin a cached
        segment that the cap would then count)."""
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = port_eval._forward(cfg, model, images[:n])
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before, (out["pred_logits"].cpu(),
                                                           out["pred_masks"].cpu())

    full_peak, want = forward_peak(OOM_BATCH)
    half_peak, _ = forward_peak(OOM_BATCH // 2)
    torch.cuda.empty_cache()
    base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(dev).total_memory
    log("oom_retry_setup", batch=OOM_BATCH, bucket=OOM_BUCKET,
        full_peak_gib=f"{full_peak / 2**30:.3f}", half_peak_gib=f"{half_peak / 2**30:.3f}",
        allocated_gib=f"{base / 2**30:.3f}", reserved_gib=f"{reserved / 2**30:.3f}")
    # The cap counts what the allocator reserves: what it keeps now (the
    # weights, and the pool of kept tables) plus a share of the half's peak.
    # cuDNN takes a smaller workspace when memory is short, so the full
    # batch's measured peak is not what it needs: the share goes down until
    # the batch no longer fits (its halves, by construction, still do).
    splits = 0
    try:
        for share in OOM_HALF_SHARES:
            cap = reserved + int(half_peak * share)
            torch.cuda.set_per_process_memory_fraction(cap / total)
            retry_if_oom.splits = 0
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            got = tuple(t.cpu() for t in port_eval.predictor_fn(cfg, model)(images))
            splits, launches = retry_if_oom.splits, ms_deform_attn_cuda.launches
            capped_peak = torch.cuda.max_memory_allocated() - base
            log("oom_retry_cap", share=share, cap_gib=f"{cap / 2**30:.3f}", splits=splits,
                k1_launches=launches, capped_peak_gib=f"{capped_peak / 2**30:.3f}")
            torch.cuda.empty_cache()
            if splits:
                break
        if not splits:
            raise AssertionError("retry_if_oom made no split down to a cap of "
                                 f"{cap / 2**30:.2f} GiB")
        eval_cap = cap + int(half_peak * OOM_EVAL_EXTRA_SHARE)
        torch.cuda.set_per_process_memory_fraction(eval_cap / total)
        retry_if_oom.splits = 0
        capped = port_eval.run_eval(cfg, model, "coco_2017_val", ims_per_batch=OOM_BATCH)
        eval_splits = retry_if_oom.splits
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(
            (torch.cuda.memory_reserved() + 2**26) / total)
        try:
            port_eval.predictor_fn(cfg, model)(images[:1])
        except torch.OutOfMemoryError as e:
            batch1 = str(e).split(":")[0]
        else:
            raise AssertionError("an image that cannot fit did not raise")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    if "batch 1" not in batch1:
        raise AssertionError(f"the batch-1 error does not say so: {batch1}")
    # splits + 1 forwards ran whole; each of the splits failed attempts may
    # have launched K1 before it ran out
    if not 6 * (splits + 1) <= launches <= 6 * (2 * splits + 1):
        raise AssertionError(f"K1 launched {launches} times over {splits + 1} forwards "
                             f"and {splits} failed ones")
    for key, g, w in zip(("pred_logits", "pred_masks"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1.5e-3)
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    log("oom_retry", batch=OOM_BATCH, bucket=OOM_BUCKET, cap_gib=f"{cap / 2**30:.3f}",
        capped_peak_gib=f"{capped_peak / 2**30:.3f}", splits=splits, k1_launches=launches,
        logits_max_abs_diff=f"{errs[0]:.3e}", masks_max_abs_diff=f"{errs[1]:.3e}",
        eval_cap_gib=f"{eval_cap / 2**30:.3f}", eval_splits=eval_splits, batch1=repr(batch1),
        AP_uncapped=f"{float(uncapped['AP']):.4f}", AP_capped=f"{float(capped['AP']):.4f}")
    if not eval_splits > 0 or capped.keys() != uncapped.keys() or any(
            abs(float(capped[k]) - float(uncapped[k])) > 1e-6 for k in capped):
        raise AssertionError(f"capped eval {capped} ({eval_splits} splits) against "
                             f"uncapped {uncapped}")
    del pred, model, got, want
    torch.cuda.empty_cache()
    return launches


def v1_path(dev):
    """Phase F: the MaskFormer-v1 models of V1_RUNS at full width from seed
    0: 3 f32 requests at 800x800 and one bf16 request; the f32 forward
    against an f64 copy of the same model on the card (norm-relative within
    V1_F64_REL); 3 `Trainer` steps at B=2, 1024x1024, 8 targets (one warm-up
    first) with the split by stage and the peak memory. Neither model has
    deformable attention: K1 and K2 launch no time (counts set to 0 just
    before each part and read just after)."""
    import copy

    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.predict import Predictor
    from bm2f_tpu_torch.train.trainer import StageTimer, Trainer, synthetic_batch
    from bm2f_tpu_torch.utils.precision import f32_scope

    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, (*REQUESTS[0], 3)).astype(np.uint8) for _ in range(3)]

    def no_deform_launch(what):
        n = (ms_deform_attn_cuda.launches + ms_deform_attn_cuda.launches_bf16
             + ms_deform_attn_bwd_cuda.launches + ms_deform_attn_bwd_cuda.launches_bf16)
        if n:
            raise AssertionError(f"v1 {what}: deformable kernels launched {n} times")

    for run, over in V1_RUNS.items():
        pred = Predictor()
        pred.setup(CONFIG, device=dev, seed=0, overrides=over)
        params = sum(p.numel() for p in pred.model.parameters())
        pred.predict(images[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        f32_ms = serve(pred, images, f"v1_{run}_f32")
        no_deform_launch("f32 serving")
        serve_peak = torch.cuda.max_memory_allocated() / 2**30

        ref = copy.deepcopy(pred.model).double()
        for part in (ref.backbone, ref.sem_seg_head.pixel_decoder, ref.sem_seg_head.predictor):
            part.dtype = torch.float64
        x = torch.from_numpy(images[0].astype(np.float32))[None].to(dev)
        with torch.no_grad(), f32_scope("float32"):
            xn = normalize_images(x, pred.cfg.model)
            a = pred.model(xn)
            b = ref.sem_seg_head(ref.backbone(xn.double().permute(0, 3, 1, 2).contiguous()))
        errs = {k: rel_err(a[k], b[k]) for k in ("pred_logits", "pred_masks")}
        del ref, a, b, pred
        torch.cuda.empty_cache()

        pred16 = Predictor()
        pred16.setup(CONFIG, device=dev, seed=0, overrides={**over, **BF16})
        pred16.predict(images[0])  # warm-up
        reset_counts()
        bf16_ms = serve(pred16, images[:1], f"v1_{run}_bf16")
        no_deform_launch("bf16 serving")
        del pred16
        torch.cuda.empty_cache()
        log("v1_serve", run=run, params=params, f32_ms="/".join(f"{m:.2f}" for m in f32_ms),
            bf16_ms=f"{bf16_ms[0]:.2f}", peak_mem_gib=f"{serve_peak:.2f}",
            **{f"{k}_f64_rel": f"{e:.3e}" for k, e in errs.items()})
        bad = {k: e for k, e in errs.items() if not e <= V1_F64_REL}
        if bad:
            raise AssertionError(f"v1 {run}: f32 against f64 beyond {V1_F64_REL}: {bad}")

        trainer = Trainer(get_config(CONFIG, over), device=dev, seed=0)
        batch = synthetic_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_INSTANCES, seed=0, device=dev)
        trainer.step(batch)  # warm-up
        torch.cuda.synchronize()
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
                raise AssertionError(f"v1 {run} step {i}: non-finite {bad}")
        no_deform_launch("training")
        log("v1_train", run=run, batch=TRAIN_BATCH, size=TRAIN_SIZE,
            instances=TRAIN_INSTANCES, total_loss=f"{metrics['total_loss']:.4f}",
            grad_norm=f"{metrics['grad_norm']:.4f}",
            step_ms="/".join(f"{m:.2f}" for m in step_ms),
            step_ms_mean=f"{sum(step_ms) / len(step_ms):.2f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            **{f"stage_{k}": f"{v / TRAIN_STEPS:.2f}ms" for k, v in timer.ms.items()})
        del trainer, batch
        torch.cuda.empty_cache()



# -- the root tools (phases H1-H5) ---------------------------------------------------
# the H phases' iteration counts, cut so that H1-H5 take about a minute;
# their shapes are the tools' own
H_ITERS = {"profile_forward": 10, "profile_kernel": 10, "profile_criterion": 3}


def tools_profile_forward():
    """Phase H1: `python -m bm2f_tpu_torch.tools.profile_forward` (its
    `main`) at its full config (B=4, 800x800, bf16): K1 on a bf16 `value`
    6 launches in a full forward and 6 in the 6-layer pixel decoder, none
    in f32; the raw op's output against `ms_deform_attn_plain` at phase
    13's tolerance. Returns (K1 f32, K1 bf16 launches of the phase, its
    segment times)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain
    from bm2f_tpu_torch.tools import profile_forward

    t0 = time.perf_counter()
    reset_counts()
    res = profile_forward.main(["--iters", str(H_ITERS["profile_forward"])])
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    per = res["launches"]
    if (per["full"], per["pixel_decoder"], per["pixel_decoder_0"],
            per["ms_deform_attn"]) != (6, 6, 0, 1) or launches[0] != 0:
        raise AssertionError(f"profile_forward: K1 bf16 launches {per} a call, f32 "
                             f"{launches[0]}; expected 6 a forward and a 6-layer pixel "
                             "decoder, 0 in f32")
    value, shapes, loc, attn, out = res.pop("raw_op")
    want = ms_deform_attn_plain(value, shapes, loc, attn)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)  # phase 13's
    log("H1", tool="profile_forward", k1_bf16_launches=launches[1],
        raw_op_max_abs_err=f"{(out - want).abs().max().item():.3e}",
        **{f"{k}_ms": f"{v:.4f}" for k, v in res["ms"].items()},
        seconds=f"{time.perf_counter() - t0:.2f}")
    del value, loc, attn, out, want
    return launches, res["ms"]


def tools_profile_kernel():
    """Phase H2: `profile_kernel` (its `main`): the full call, the
    preparation and the launch alone; the full call takes no less than the
    launch alone, whose output is bitwise the full call's. Returns (K1 f32,
    bf16 launches, the three times)."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.tools import profile_kernel

    t0 = time.perf_counter()
    reset_counts()
    res = profile_kernel.main(["--iters", str(H_ITERS["profile_kernel"])])
    launches = (ms_deform_attn_cuda.launches, ms_deform_attn_cuda.launches_bf16)
    ms = res["ms"]
    if not res["bitwise"] or ms["full"] < ms["kernel"] or launches[0] or not launches[1]:
        raise AssertionError(f"profile_kernel: {ms}, bitwise {res['bitwise']}, K1 "
                             f"launches {launches}")
    log("H2", tool="profile_kernel", k1_bf16_launches=launches[1],
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
        ns_per_desc="/".join(f"{v * 1e6 / res['ndesc']:.3f}" for v in ms.values()),
        seconds=f"{time.perf_counter() - t0:.2f}")
    return launches, ms


def tools_profile_criterion():
    """Phase H3: `profile_criterion --iters 3`: a finite loss and its time;
    neither K1 nor K2 launches."""
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_bwd_cuda, ms_deform_attn_cuda
    from bm2f_tpu_torch.tools import profile_criterion

    t0 = time.perf_counter()
    reset_counts()
    res = profile_criterion.main(["--iters", str(H_ITERS["profile_criterion"])])
    counts = [f.launches + f.launches_bf16 for f in (ms_deform_attn_cuda,
                                                      ms_deform_attn_bwd_cuda)]
    if not np.isfinite(res["loss"]) or any(counts):
        raise AssertionError(f"profile_criterion: loss {res['loss']}, K1 / K2 launches "
                             f"{counts}")
    log("H3", tool="profile_criterion", loss=f"{res['loss']:.4f}",
        ms_per_step=f"{res['ms']:.3f}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    return res["ms"]


def tools_analyze_model():
    """Phase H4: `analyze_model` on CONFIG at 800 on the card: the
    parameter table and the FLOPs through K1 (6 launches), then the FLOPs
    of the same model with the deformable core routed through
    `ms_deform_attn_plain`: the same numbers. Returns K1's f32 launches."""
    from bm2f_tpu_torch.ops import deform_attn
    from bm2f_tpu_torch.tools import analyze_model

    t0 = time.perf_counter()
    argv = ["--config", CONFIG, "--size", "800"]
    k1_fn = deform_attn.ms_deform_attn_cuda
    reset_counts()
    res = analyze_model.main(argv)
    k1 = k1_fn.launches
    reset_counts()
    with mock.patch.object(deform_attn, "ms_deform_attn_cuda",
                           lambda v, s, l, a: deform_attn.ms_deform_attn_plain(v, s, l, a)):
        plain = analyze_model.main(argv + ["--tasks", "flops"])
    k1_plain = k1_fn.launches
    if k1 != 6 or k1_plain != 0 or (res["flops"], res["k1_flops"]) != (
            plain["flops"], plain["k1_flops"]):
        raise AssertionError(f"analyze_model: FLOPs {res['flops']} + {res['k1_flops']} "
                             f"through K1 ({k1} launches) against {plain['flops']} + "
                             f"{plain['k1_flops']} through the plain version")
    log("H4", tool="analyze_model", params=res["params"],
        flops=res["flops"], k1_flops=res["k1_flops"], k1_launches=k1,
        seconds=f"{time.perf_counter() - t0:.2f}")
    return k1


def tools_zoo_parity(data_root: str):
    """Phase H5: `zoo_parity` from a checkpoint of the port, on a split
    whose instances are the model's own predictions, so that its AP depends
    on the weights. A seeded f32 CONFIG (its deformable projections
    perturbed as phase 5's) predicts phase 19's images through `run_eval`;
    `write_predicted_instances` writes them as the split's instances, and
    `run_eval` on that split gives the model's AP (100 where its masks are
    not empty). The model is saved with the port's Checkpointer, as phase
    23 saves one, and so is another seed's model. `zoo_parity` with
    `--expected AP=<that AP>` at tolerance 1e-6: exit 0 from the model's
    checkpoint; exit 1 with the zoo's AP 43.7, and from the other seed's
    checkpoint. K1 6 launches an image in each of the five evals. Returns
    K1's f32 launches."""
    import os

    from bm2f_tpu_torch import eval as port_eval
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
    from bm2f_tpu_torch.data.synthetic import write_predicted_instances
    from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator
    from bm2f_tpu_torch.models import build_model
    from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda
    from bm2f_tpu_torch.tools import zoo_parity
    from bm2f_tpu_torch.tools.profile_request import perturb_deformable
    from bm2f_tpu_torch.train.checkpoint import Checkpointer

    t0 = time.perf_counter()
    n = len(DatasetCatalog.get("coco_2017_val"))
    cfg = get_config(CONFIG)
    model = build_model(cfg, device="cuda", seed=0)
    perturb_deformable(model)
    seen = []
    process = COCOMaskAPEvaluator.process

    def recorded(self, pred, gt):
        seen.append((pred["labels"], pred["masks"]))
        return process(self, pred, gt)

    pred_root = os.path.join(data_root, "zoo")
    mine, other = (tempfile.mkdtemp(prefix=f"chip_smoke_zoo_{k}_", dir=ROOT / "output")
                   for k in ("mine", "other"))
    try:
        reset_counts()
        with mock.patch.object(COCOMaskAPEvaluator, "process", recorded):
            port_eval.run_eval(cfg, model, "coco_2017_val")
        write_predicted_instances(pred_root, data_root, seen, cfg.model.num_classes)
        register_all_builtin_datasets(pred_root, force=True)
        ap = port_eval.run_eval(cfg, model, "coco_2017_val")["AP"]
        Checkpointer(mine).save_state(0, {"step": 0, "model": model.state_dict()})
        del model
        Checkpointer(other).save_state(
            0, {"step": 0, "model": build_model(cfg, device="cuda", seed=1).state_dict()})
        os.environ["DETECTRON2_DATASETS"] = pred_root
        argv = ["--config", CONFIG, "--dataset", "coco_2017_val", "--weights"]
        exact = ["--expected", f"AP={float(ap)!r}", "--tolerance", "1e-6"]
        codes = (zoo_parity.main(argv + [mine] + exact), zoo_parity.main(argv + [mine]))
        res_other, ok_other = zoo_parity.zoo_parity(
            CONFIG, "coco_2017_val", other, {"AP": float(ap)}, 1e-6)
    finally:
        for d in (mine, other):
            shutil.rmtree(d, ignore_errors=True)
        register_all_builtin_datasets(data_root, force=True)
    k1 = ms_deform_attn_cuda.launches
    if (codes != (0, 1) or ok_other or k1 != 5 * 6 * n or ms_deform_attn_cuda.launches_bf16
            or not ap > res_other["AP"]):
        raise AssertionError(f"zoo_parity: exit codes {codes} (expected 0, 1), AP {ap} "
                             f"against {res_other['AP']} from seed 1 (gate {ok_other}), K1 "
                             f"launches {k1} (expected {5 * 6 * n})")
    log("H5", tool="zoo_parity", AP=repr(float(ap)), AP_seed1=repr(float(res_other["AP"])),
        exit_codes=codes, gt_instances=sum(int(np.asarray(m).any((1, 2)).sum())
                                           for _, m in seen),
        images=n, k1_launches=k1, seconds=f"{time.perf_counter() - t0:.2f}")
    return k1


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

    # -- 12b. the box matcher's pairwise sums -------------------------------------
    pc_err, pc_ms, pc_plain_ms, pc_cost_ms, pc_bound, pc_by = check_pairwise_cost(dev)
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

    # -- G1. DDP in a world-1 NCCL group, bitwise the plain trainer ---------------------
    k_ddp1 = ddp_world1(dev)
    torch.cuda.empty_cache()

    # -- G2. two ranks on the one card in a gloo group against one process ------------
    k_ddp2 = ddp_two_ranks_gloo(dev)
    torch.cuda.empty_cache()

    # -- T1. K1 and K2 at a rank's share of the heads -----------------------------------
    tp_rows = tp_kernels(dev, gen)
    torch.cuda.empty_cache()

    # -- T2, T3. two tensor-parallel ranks on the one card; the checkpoint resumed ------
    k_tp = tp_two_ranks_gloo(dev)

    # -- 19. the eval's data ------------------------------------------------------------
    data_root, _ = write_eval_dataset(ROOT / "output")
    try:
        # -- 20. the eval path ------------------------------------------------------------
        eval_launches, _, eval_preds = eval_path()
        torch.cuda.empty_cache()

        # -- 21. the ground truth as predictions ------------------------------------------
        gt_oracle()

        # -- 22. K1 at the eval buckets ---------------------------------------------------
        k1_buckets = check_k1_eval_buckets(eval_preds["f32"])
        torch.cuda.empty_cache()

        # -- 23. weights through the port's checkpoint and --weights ----------------------
        weights_round_trip(eval_preds["f32"], data_root)
        del eval_preds
        torch.cuda.empty_cache()

        # -- 24. the weak train path, and the mask step on the same batches ---------------
        from bm2f_tpu_torch.config import get_config

        batches = weak_batches(get_config(WEAK_CONFIG, WEAK_OVER), dev, TRAIN_STEPS + 1)
        trainer = make_weak_trainer(WEAK_CONFIG, dev)
        (k1_weak, k2_weak), _ = weak_train_path(trainer, batches, dev, "weak")
        pc_weak = pairwise_launches("weak")

        # -- 25. the weak step against the plain path; repeatability ----------------------
        weak_parity(trainer, batches[-1], dev)
        del trainer
        torch.cuda.empty_cache()
        weak_repeats(batches, dev)
        torch.cuda.empty_cache()
        trainer = make_weak_trainer(WEAK_MASK_CONFIG, dev)
        (k1_mask_wo_lsj, k2_mask_wo_lsj), _ = weak_train_path(trainer, batches, dev, "mask")
        del trainer, batches
        torch.cuda.empty_cache()

        # -- 26. the train entry point on the dataset, with an eval -----------------------
        entry_point_run(data_root)

        # -- G3. the entry point as one rank of torch.distributed.run (NCCL) --------------
        entry_point_run(data_root, distributed=True)

        # -- B. the demo on phase 19's images ----------------------------------------------
        k1_demo = demo_path(data_root)
        torch.cuda.empty_cache()

        # -- D. the semantic eval with test-time augmentation -------------------------------
        k1_tta = tta_path(dev)

        # -- E. retry_if_oom forced on the card ---------------------------------------------
        k1_oom = oom_retry_path(dev)
        torch.cuda.empty_cache()

        # -- H5. zoo_parity on the split, from a checkpoint of the port ---------------------
        k1_zoo = tools_zoo_parity(data_root)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    # -- 27. the video data ---------------------------------------------------------------
    video_root, feats_root = write_video_dataset(ROOT / "output")
    try:
        # -- 28. the video eval, and the ground truth as predictions ----------------------
        vcfg, vmodel = make_video_model()
        k1_video_eval, _ = video_eval_path(vcfg, vmodel)
        video_gt_oracle(vcfg)

        # -- 29. a clip padded to its frame bucket, whole and stage by stage -------------
        video_padding_parity(vcfg, vmodel)
        video_padding_stages(vcfg, vmodel)

        # -- 30. K1 at the video eval shapes, K2 at the video train shape ----------------
        k1_video_rows = video_k1_rows(vcfg, vmodel)
        del vmodel
        torch.cuda.empty_cache()
        k2_video_row = video_k2_row(dev)
        torch.cuda.empty_cache()

        # -- 31. video training -----------------------------------------------------------
        k_video = {}
        for path, config in (("mask", VIDEO_MASK_CONFIG), ("weak", VIDEO_WEAK_CONFIG)):
            batches = video_batches(config, dev, TRAIN_STEPS + 1, feats_root)
            trainer = make_weak_trainer(config, dev, over=VIDEO_OVER)
            if path == "mask":
                video_k2_against_f64(trainer, batches[0], dev)
            k_video[path], _ = weak_train_path(trainer, batches, dev, f"video_{path}",
                                               tag="video", nonzero=VIDEO_WEAK_LOSSES)
            if path == "weak":
                pc_video = pairwise_launches("video_weak")
            if path == "weak":
                # -- 32. the weak video step against the plain path; repeatability --------
                video_weak_parity(trainer, batches[-1])
                del trainer
                torch.cuda.empty_cache()
                weak_repeats(batches, dev, VIDEO_WEAK_CONFIG, VIDEO_OVER)
            trainer = batches = None
            torch.cuda.empty_cache()

        # -- 33. the train entry point on the video splits, with an eval ------------------
        video_entry_point_run(video_root)

        # -- 34. Swin-L's backbone in f32 against f64 -------------------------------------
        swin_backbone_f64(dev)
        torch.cuda.empty_cache()

        # -- 35. serving Swin-L --------------------------------------------------------------
        k1_swin_serve, k1_swin_serve_row = swin_serve(images, dev)

        # -- 36. training Swin-L -------------------------------------------------------------
        k1_swin_train, k2_swin_train = swin_train(dev)

        # -- 37. the video eval on Swin-L ---------------------------------------------------
        k1_swin_video, k1_swin_video_row = swin_video(dev)
        torch.cuda.empty_cache()

        # -- C. the video demo on phase 27's 19-frame clip ----------------------------------
        k1_demo_video = demo_video_path(video_root)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(video_root, ignore_errors=True)

    # -- A. the predictor's default config, with the visualization ---------------------
    k1_predictor = predictor_visualization(dev)

    # -- F. the MaskFormer-v1 models -------------------------------------------------------
    v1_path(dev)
    torch.cuda.empty_cache()

    # -- H1-H4. the root tools: the forward's segments, K1 apart, the criterion, FLOPs -----
    k_h1, _ = tools_profile_forward()
    torch.cuda.empty_cache()
    k_h2, _ = tools_profile_kernel()
    tools_profile_criterion()
    torch.cuda.empty_cache()
    k1_analyze = tools_analyze_model()

    # -- 38. result ---------------------------------------------------------
    k_ms, p_ms, bound, by = timing[1]
    k1_pd_f32 = bf16_launches["bf16_pd_f32"][0]
    k1_eval = sum(n for n, _ in eval_launches.values())
    k1b_eval = sum(n for _, n in eval_launches.values())
    kernels = [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:102",
        "launches": (launches + k1_train + k1_pd_f32 + k1_eval + k1_weak + k1_mask_wo_lsj
                     + k1_video_eval + k_video["mask"][0] + k_video["weak"][0]
                     + k1_swin_serve + k1_swin_train + k1_swin_video + k1_predictor
                     + k1_demo + k1_demo_video + k1_tta + k1_oom + k_ddp1[0] + k_ddp2[0]
                     + k_tp[0] + k1_analyze + k1_zoo),
        "launches_by_path": {"serve": launches, "train": k1_train, "train_weak": k1_weak,
                             "train_ddp_world1_nccl": k_ddp1[0],
                             "train_ddp_two_ranks_gloo": k_ddp2[0],
                             "train_tp_two_ranks_gloo_m4": k_tp[0],
                             "train_wo_lsj": k1_mask_wo_lsj,
                             "serve_bf16_pixel_decoder_f32": k1_pd_f32,
                             **{f"eval_{r}": n for r, (n, _) in eval_launches.items() if n},
                             "eval_video": k1_video_eval, "train_video": k_video["mask"][0],
                             "train_video_weak": k_video["weak"][0],
                             "serve_swin_l": k1_swin_serve, "train_swin_l": k1_swin_train,
                             "eval_video_swin_l": k1_swin_video,
                             "predictor_panoptic_and_cli": k1_predictor, "demo": k1_demo,
                             "demo_video": k1_demo_video, "eval_tta": k1_tta,
                             "eval_oom_retry": k1_oom, "v1_fpn_and_transformer_fpn": 0,
                             "tools_analyze_model": k1_analyze, "tools_zoo_parity": k1_zoo},
        "eval_buckets": {str(b): row for (b, dt), row in k1_buckets.items() if dt == "f32"},
        "video_buckets": {f"Tp{tp}_S{row['S']}": row for tp, row in k1_video_rows.items()},
        "swin_l": {"serve_800x800": k1_swin_serve_row, "video": k1_swin_video_row},
        "tp_heads": {f"M{m}": r["fwd"] for m, r in tp_rows.items()},
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
        "launches": (k2_train + k2_weak + k2_mask_wo_lsj + k_video["mask"][1]
                     + k_video["weak"][1] + k2_swin_train + k_ddp1[1] + k_ddp2[1]
                     + k_tp[1]),
        "launches_by_path": {"serve": k2_serve, "train": k2_train, "train_weak": k2_weak,
                             "train_ddp_world1_nccl": k_ddp1[1],
                             "train_ddp_two_ranks_gloo": k_ddp2[1],
                             "train_tp_two_ranks_gloo_m4": k_tp[1],
                             "train_wo_lsj": k2_mask_wo_lsj, "train_bf16": 0,
                             "train_video": k_video["mask"][1],
                             "train_video_weak": k_video["weak"][1],
                             "train_swin_l": k2_swin_train},
        "video_train": k2_video_row,
        "tp_heads": {f"M{m}": r["bwd"] for m, r in tp_rows.items()},
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
        "launches": bf16_launches["bf16"][1] + k1b_train + k1b_eval + k_h1[1] + k_h2[1],
        "launches_by_path": {"serve_bf16": bf16_launches["bf16"][1], "train_bf16": k1b_train,
                             **{f"eval_{r}": n for r, (_, n) in eval_launches.items() if n},
                             "tools_profile_forward": k_h1[1],
                             "tools_profile_kernel": k_h2[1]},
        "eval_buckets": {str(b): row for (b, dt), row in k1_buckets.items() if dt == "bf16"},
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
    kernels.append({
        "name": "pairwise_lsp_sum",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/pairwise_cost.cu",
        "replaces": None,  # the port's alone: the JAX package leaves it to XLA's einsum
        "launches": pc_weak + pc_video,
        "launches_by_path": {"train_weak": pc_weak, "train_video_weak": pc_video},
        "max_abs_err": pc_err,
        "ms": pc_ms,
        "plain_ms": pc_plain_ms,
        "pairwise_cost_matrix_ms": pc_cost_ms,
        "bound_ms": pc_bound,
        "bound_by": pc_by,
        "library_ms": None,
    })
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
