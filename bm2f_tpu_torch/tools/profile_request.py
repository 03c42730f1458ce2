"""Where the time of one served request goes, on the card.

    python -m bm2f_tpu_torch.tools.profile_request [--size 800x800] [--repeats 5]

Builds `Predictor("coco_instance_r50")` at full width with seeded random
weights (deformable projections perturbed as in `chip_smoke.py`, so sampling
is not on the init's grid), answers one warm-up request, then:
  1. times each step of `Predictor.predict` with a synchronise after it
     (median over --repeats requests): pad + upload, backbone, pixel
     decoder, predictor, mask resize, semantic, instance, panoptic, copy to
     the host, panoptic relabel;
  2. profiles one request with `torch.profiler`, writes the op tables to
     --out (default output/profile_request.txt) and prints the device-busy
     share of the profiled request and of the unprofiled median.
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

from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic
from bm2f_tpu_torch.models.maskformer import (
    instance_inference,
    normalize_images,
    panoptic_inference,
    semantic_inference,
)
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.predict import Predictor


def perturb_deformable(model, seed: int = 1) -> None:
    """Small seeded weights for the zero-init sampling-offset and attention
    projections, so that the kernel sees general locations."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.sem_seg_head.pixel_decoder.transformer.encoder.layers:
            for lin, std in ((layer.self_attn.sampling_offsets, 0.1),
                             (layer.self_attn.attention_weights, 0.05)):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * std)


def timed_request(pred: Predictor, image: np.ndarray) -> dict:
    """`Predictor.predict`'s steps, each followed by a synchronise."""
    cfg, dev, model = pred.cfg, pred.device, pred.model
    t = {}
    clock = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        t[name] = (now - clock[0]) * 1e3
        clock[0] = now

    with torch.no_grad():
        H, W = image.shape[:2]
        d = cfg.model.size_divisibility
        ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
        x = torch.zeros((1, ph, pw, 3), dtype=torch.float32)
        x[0, :H, :W] = torch.from_numpy(image.astype(np.float32))
        x = normalize_images(x.to(dev), cfg.model).permute(0, 3, 1, 2).contiguous()
        mark("upload")
        feats = model.backbone(x)
        mark("backbone")
        mf, _, ms = model.sem_seg_head.pixel_decoder(feats)
        mark("pixel_decoder")
        out = model.sem_seg_head.predictor(ms, mf)
        mark("predictor")
        logits = out["pred_logits"][0]
        masks = resize_bilinear(out["pred_masks"][0], ph, pw)[:, :H, :W]
        mark("mask_resize")
        K = cfg.model.num_classes
        sem = semantic_inference(logits, masks)
        mark("semantic")
        inst = instance_inference(logits, masks, num_classes=K, topk=100)
        mark("instance")
        pan = panoptic_inference(
            logits, masks, num_classes=K, thing_mask=tuple([True] * K),
            object_mask_threshold=cfg.model.test.object_mask_threshold,
            overlap_threshold=cfg.model.test.overlap_threshold)
        mark("panoptic")
        sem_h = sem.cpu().numpy()
        inst_h = {k: v.cpu().numpy() for k, v in inst.items()}
        pan_h = {k: v.cpu().numpy() for k, v in pan.items()}
        mark("to_host")
        _, info = relabel_panoptic(pan_h)
        mark("relabel")
    del sem_h, inst_h
    t["segments"] = len(info)
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="800x800")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="output/profile_request.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_request: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = (int(v) for v in args.size.split("x"))
    pred = Predictor()
    pred.setup("coco_instance_r50", device="cuda", seed=0)
    perturb_deformable(pred.model)
    image = np.random.RandomState(0).randint(0, 256, (h, w, 3)).astype(np.uint8)
    pred.predict(image)  # warm-up

    runs = [timed_request(pred, image) for _ in range(args.repeats)]
    steps = [k for k in runs[0] if k != "segments"]
    med = {k: statistics.median(r[k] for r in runs) for k in steps}
    print(f"device={torch.cuda.get_device_name(0)!r} size={args.size} "
          f"repeats={args.repeats} segments={runs[0]['segments']}")
    print("steps_ms_median " + " ".join(f"{k}={v:.2f}" for k, v in med.items())
          + f" total={sum(med.values()):.2f}")

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
    # the profiler slows the host; the median of the timed requests above
    # (a synchronise after each step) is the request without it
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
