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
  4. kernel timing (CUDA events) beside the plain version and the bound;
  5. the main path: `Predictor` on `coco_instance_r50` at full width with
     seeded random weights answers 3 requests; every kernel's launch count
     is set to 0 just before and read just after;
  6. forward parity on the card: kernel path against the plain path;
  7. one JSON line {"kernels": [...]}, then the nvidia-smi line, then the
     result line {"ok": true, "device": {...}} last.

Any failure raises and the script exits non-zero. It imports nothing of JAX
or of the JAX package. TF32 is off for matmuls and convolutions throughout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# main-path shapes of the deformable-attention kernel: coco_instance_r50 at
# 800x800 -> levels 25x25, 50x50, 100x100 (strides 32, 16, 8)
MAIN_SHAPES = ((25, 25), (50, 50), (100, 100))
M, D, P = 8, 32, 4
REQUESTS = ((800, 800), (480, 640), (800, 1088))


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
    """value, locations, attention weights from a seeded generator. With
    `loc_range` the locations are uniform in it; else they sit around the
    encoder's reference points, a few pixels off, as in the model."""
    from bm2f_tpu_torch.models.pixel_decoder import encoder_reference_points

    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(B, S, M, D, generator=gen).to(dev)
    if loc_range is not None:
        lo, hi = loc_range
        loc = torch.rand(B, Q, M, L, P, 2, generator=gen) * (hi - lo) + lo
    else:
        ref = encoder_reference_points(shapes)[:Q]  # (Q, L, 2)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        off = torch.randn(B, Q, M, L, P, 2, generator=gen) * 2.0
        loc = ref[None, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    attn = torch.softmax(torch.randn(B, Q, M, L * P, generator=gen), -1)
    return value, loc.contiguous().to(dev), attn.view(B, Q, M, L, P).to(dev)


def deform_bound_ms(B, shapes, Q, L):
    S = sum(h * w for h, w in shapes)
    n_bytes = 4 * (B * S * M * D + B * Q * M * L * P * 2 + B * Q * M * L * P
                   + B * Q * M * D)
    flops = 2 * 4 * B * Q * M * L * P * D  # one FMA per corner and channel
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, flops


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
    sources = sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    built = cuda_build.build(sources)
    log("build", sources=",".join(sources), seconds=f"{time.perf_counter() - t0:.2f}")
    for src, (lib, secs, compiler_log) in built.items():
        ptxas = [ln.strip() for ln in compiler_log.splitlines()
                 if "registers" in ln or "spill" in ln]
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
        bound, by, n_bytes, flops = deform_bound_ms(B, MAIN_SHAPES, S_main, 3)
        timing[B] = (k_ms, p_ms, bound, by)
        log("time", kernel="ms_deform_attn_fwd", B=B, ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", grid_sample_composite_ms=f"{g_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by, bytes=n_bytes, flops=flops,
            share_of_bound=f"{bound / k_ms:.3f}")
    del main_inputs

    # -- 5. main path -------------------------------------------------------
    pred = Predictor()
    t0 = time.perf_counter()
    pred.setup("coco_instance_r50", device="cuda", seed=0)
    perturb_deformable(pred.model)  # general sampling locations, not a grid
    torch.cuda.synchronize()
    log("setup", config="coco_instance_r50", seconds=f"{time.perf_counter() - t0:.2f}",
        params=sum(p.numel() for p in pred.model.parameters()))
    img_rng = np.random.RandomState(0)
    images = [img_rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUESTS]
    pred.predict(images[0])  # warm-up (cuDNN algorithm choice), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ms_deform_attn_cuda.launches = 0
    latencies = []
    for img in images:
        t0 = time.perf_counter()
        out = pred.predict(img)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        H, W = img.shape[:2]
        K = pred.cfg.model.num_classes
        if out["semantic"].shape != (H, W, K) or not np.isfinite(out["semantic"]).all():
            raise AssertionError(f"semantic output {out['semantic'].shape} bad")
        inst = out["instances"]
        if inst["masks"].shape != (100, H, W) or not np.isfinite(inst["scores"]).all():
            raise AssertionError(f"instance output {inst['masks'].shape} bad")
        if out["panoptic"][0].shape != (H, W):
            raise AssertionError("panoptic output shape bad")
    launches = ms_deform_attn_cuda.launches
    if launches != 6 * len(images):
        raise AssertionError(f"ms_deform_attn_fwd launched {launches} times, "
                             f"expected {6 * len(images)}")
    for (h, w), ms in zip(REQUESTS, latencies):
        log("request", size=f"{h}x{w}", latency_ms=f"{ms:.2f}")
    log("main", launches=launches,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # stage split of one 800x800 request (synchronised between stages)
    model = pred.model
    x = torch.zeros((1, 800, 800, 3))
    x[0] = torch.from_numpy(images[0].astype(np.float32))
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
    log("stages", **{k: f"{v:.2f}ms" for k, v in stages.items()})

    # -- 6. forward parity: kernel path vs plain path -----------------------
    with torch.no_grad():
        xn = normalize_images(x.to(dev), pred.cfg.model)
        a = model(xn)
        b = model(xn, deform_impl="plain")
    for key in ("pred_logits", "pred_masks"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-3, atol=1.5e-3)
        log("parity", key=key, max_abs_diff=f"{(a[key] - b[key]).abs().max().item():.3e}")

    # -- 7. result ----------------------------------------------------------
    k_ms, p_ms, bound, by = timing[1]
    kernels = [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "bm2f_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "bm2f_tpu/ops/deform_attn_pallas.py:102",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
