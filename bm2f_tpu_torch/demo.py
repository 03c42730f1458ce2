"""Demo of the port: segmentation of images, with visualizations (the
counterpart of the root `demo.py`; reference: demo/demo.py +
demo/predictor.py VisualizationDemo).

    python -m bm2f_tpu_torch.demo --config coco_instance_r50 --input img.jpg \\
        [img2.jpg ...] --output out/ [--weights W] \\
        [--task instance|semantic|panoptic] [--confidence 0.5] [--device cuda] \\
        [--depth 2] [--set KEY=VALUE ...]

One `<input name>.viz.png` is written per input. `--weights` takes what
`utils.convert_weights.load_weights` takes (a detectron2 .pkl/.pth, a
checkpoint directory of the port or an orbax directory of the JAX package);
none draws seeded random weights. Labels come from the built-in COCO tables
when the class count matches (`data/datasets/coco_meta.py`).

The images go through `utils.async_predictor.AsyncPredictor`: a loader
thread reads and pads the next image (into pinned host memory on the card)
while the device runs the network, the task's inference and the copy of
its results into pinned host memory for this one, and the caller thread
waits for the previous one's copy (an event, not the stream) and draws it. The drawing helpers are copies of the root `demo.py`'s (numpy and
PIL), and give the same arrays.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence


def color_palette(n: int):
    import numpy as np

    rng = np.random.RandomState(7)
    return (rng.rand(n, 3) * 180 + 60).astype(np.uint8)


def draw_instances(img, masks, labels, scores, class_names=None, score_thr=0.5):
    import numpy as np
    from PIL import Image, ImageDraw

    out = img.copy().astype(np.float32)
    palette = color_palette(len(masks))
    keep = [i for i, s in enumerate(scores) if s >= score_thr]
    for i in keep:
        m = masks[i].astype(bool)
        out[m] = 0.5 * out[m] + 0.5 * palette[i]
    pil = Image.fromarray(out.astype(np.uint8))
    d = ImageDraw.Draw(pil)
    for i in keep:
        ys, xs = np.nonzero(masks[i])
        if len(ys) == 0:
            continue
        name = (
            class_names[int(labels[i])]
            if class_names and int(labels[i]) < len(class_names)
            else str(int(labels[i]))
        )
        d.text((int(xs.min()), int(ys.min())), f"{name} {scores[i]:.2f}",
               fill=(255, 255, 255))
    return np.asarray(pil)


def draw_semantic(img, sem_probs):
    import numpy as np

    seg = np.asarray(sem_probs).argmax(-1)
    palette = color_palette(int(seg.max()) + 1)
    overlay = palette[seg]
    return (0.5 * img + 0.5 * overlay).astype(np.uint8)


def draw_panoptic(img, seg_map, segments, class_names=None):
    """Per-segment colors + category labels at segment centroids (reference:
    demo/demo.py:39 run_on_image -> d2 Visualizer.draw_panoptic_seg: stuff
    drawn as tinted regions, things with instance colors, every segment
    labeled with its category name)."""
    import numpy as np
    from PIL import Image, ImageDraw

    palette = color_palette(len(segments) + 1)
    out = img.copy().astype(np.float32)
    for seg in segments:
        m = seg_map == seg["id"]
        # stuff regions get a lighter tint than thing instances, like the
        # Visualizer's lower stuff alpha
        alpha = 0.5 if seg["isthing"] else 0.35
        out[m] = (1 - alpha) * out[m] + alpha * palette[seg["id"]]
    pil = Image.fromarray(out.astype(np.uint8))
    d = ImageDraw.Draw(pil)
    for seg in segments:
        ys, xs = np.nonzero(seg_map == seg["id"])
        if len(ys) == 0:
            continue
        cid = int(seg["category_id"])
        name = (
            class_names[cid]
            if class_names and cid < len(class_names)
            else str(cid)
        )
        cy, cx = int(np.median(ys)), int(np.median(xs))
        d.text((cx, cy), name, fill=(255, 255, 255))
    return np.asarray(pil)


def run_demo(cfg, model, paths: Sequence[str], output: str, task: str = "instance",
             confidence: float = 0.5, depth: int = 2) -> Dict:
    """Writes `<output>/<name>.viz.png` for each path; returns {"written":
    the paths written, "wall_s", "stage_s": the host time summed over the
    images in each stage ("preprocess" in the loader thread, "predict" the
    launches, "postprocess" the copies to the host, which wait for the
    device, and the drawing)}. The masks are resized to the padded size and
    then cropped (root demo.py:170-173)."""
    import numpy as np
    import torch
    from PIL import Image

    from bm2f_tpu_torch.data.datasets.coco_meta import default_demo_metadata
    from bm2f_tpu_torch.data.mappers import read_image
    from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic
    from bm2f_tpu_torch.models.maskformer import (
        instance_inference,
        normalize_images,
        panoptic_inference,
        semantic_inference,
    )
    from bm2f_tpu_torch.ops import resize_bilinear
    from bm2f_tpu_torch.utils.async_predictor import AsyncPredictor
    from bm2f_tpu_torch.utils.host_copy import to_host
    from bm2f_tpu_torch.utils.precision import f32_scope

    device = next(model.parameters()).device
    K = cfg.model.num_classes
    class_names, thing_mask = default_demo_metadata(K)
    os.makedirs(output, exist_ok=True)
    stage_s = {"preprocess": 0.0, "predict": 0.0, "postprocess": 0.0}

    def preprocess(path):  # loader thread: host work and a pinned copy only
        t0 = time.perf_counter()
        img = read_image(path)
        H, W = img.shape[:2]
        d = cfg.model.size_divisibility
        ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
        x = torch.zeros((1, ph, pw, 3), dtype=torch.float32,
                        pin_memory=device.type == "cuda")
        x[0, :H, :W] = torch.tensor(img)
        stage_s["preprocess"] += time.perf_counter() - t0
        return {"img": img, "x": x, "hw": (H, W), "phw": (ph, pw)}

    @torch.no_grad()
    def run_model(inp):  # launches only: the host waits for nothing here
        t0 = time.perf_counter()
        H, W = inp["hw"]
        with f32_scope(cfg.model.dtype):
            out = model(normalize_images(inp["x"].to(device, non_blocking=True), cfg.model))
            logits = out["pred_logits"][0]
            masks = resize_bilinear(out["pred_masks"][0], *inp["phw"])[:, :H, :W]
            if task == "semantic":
                res = {"sem": semantic_inference(logits, masks)}
            elif task == "panoptic":
                res = panoptic_inference(
                    logits, masks, num_classes=K, thing_mask=thing_mask,
                    object_mask_threshold=cfg.model.test.object_mask_threshold,
                    overlap_threshold=cfg.model.test.overlap_threshold)
            else:
                res = instance_inference(logits, masks, num_classes=K, topk=100)
        res, done = to_host(res, device)
        stage_s["predict"] += time.perf_counter() - t0
        return inp, res, done

    def visualize(path, result):
        t0 = time.perf_counter()
        inp, res, done = result
        if done is not None:
            done.synchronize()  # this image's copies only, not the next forward
        host = {k: v.numpy() for k, v in res.items()}
        img = inp["img"]
        if task == "semantic":
            vis = draw_semantic(img, host["sem"])
        elif task == "panoptic":
            seg_map, segments = relabel_panoptic(host)
            vis = draw_panoptic(img, seg_map, segments, class_names)
        else:
            vis = draw_instances(img, host["masks"], host["labels"], host["scores"],
                                 class_names=class_names, score_thr=confidence)
        out_path = os.path.join(output, os.path.basename(path) + ".viz.png")
        Image.fromarray(vis).save(out_path)
        stage_s["postprocess"] += time.perf_counter() - t0
        print(f"wrote {out_path}")
        return out_path

    t0 = time.perf_counter()
    written = [out for _, out in AsyncPredictor(run_model, preprocess, visualize,
                                                depth=depth)(paths)]
    return {"written": written, "wall_s": time.perf_counter() - t0, "stage_s": stage_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from bm2f_tpu_torch.config import parse_override

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--input", nargs="+", required=True)
    ap.add_argument("--output", default="demo_out")
    ap.add_argument("--weights", default="")
    ap.add_argument("--task", default="instance",
                    choices=["instance", "semantic", "panoptic"])
    ap.add_argument("--confidence", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE", help="a config field, e.g. model.dtype=bfloat16")
    ap.add_argument("--depth", type=int, default=2,
                    help="images in flight on the device (1: no overlap)")
    args = ap.parse_args(argv)

    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.models.maskformer import build_model

    cfg = get_config(args.config, dict(args.set))
    model = build_model(cfg, device=args.device)
    if args.weights:
        from bm2f_tpu_torch.utils.convert_weights import load_weights

        model.load_state_dict(load_weights(args.weights, cfg), strict=True)
    model.cast_weights_for_inference_()
    return run_demo(cfg, model, args.input, args.output, args.task, args.confidence,
                    args.depth)


if __name__ == "__main__":
    main()
