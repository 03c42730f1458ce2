"""Boundary-IoU AP (reference: tools/evaluate_coco_boundary_ap.py, as the
JAX package writes it): boundary IoU(A, B) = IoU(A ∩ Ad, B ∩ Bd), where Xd
is the set of pixels within distance d of X's boundary (Cheng et al.,
Boundary IoU, CVPR 2021; d = 0.02 of the image diagonal), scored by the
port's COCO mask AP evaluator on the boundary regions. Host numpy.

    python -m bm2f_tpu_torch.tools.evaluate_coco_boundary_ap \\
        --gt-json instances_val.json --pred-json results.json
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np


def mask_to_boundary_region(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Pixels of `mask` within d of its boundary (erosion-based, numpy)."""
    h, w = mask.shape
    d = max(1, int(round(dilation_ratio * np.sqrt(h * h + w * w))))
    m = mask.astype(bool)
    eroded = m.copy()
    for _ in range(d):
        shrunk = eroded.copy()
        shrunk[1:] &= eroded[:-1]
        shrunk[:-1] &= eroded[1:]
        shrunk[:, 1:] &= eroded[:, :-1]
        shrunk[:, :-1] &= eroded[:, 1:]
        eroded = shrunk
    return m & ~eroded


def boundary_iou(a: np.ndarray, b: np.ndarray, dilation_ratio: float = 0.02) -> float:
    ab = mask_to_boundary_region(a, dilation_ratio)
    bb = mask_to_boundary_region(b, dilation_ratio)
    inter = np.logical_and(ab, bb).sum()
    union = np.logical_or(ab, bb).sum()
    return float(inter) / union if union else 0.0


def boundary_ap(gt: dict, preds: list, dilation_ratio: float = 0.02) -> dict:
    """AP of `preds` (COCO results: RLE masks) against the COCO instances
    `gt`, both on the masks' boundary regions."""
    from bm2f_tpu_torch.data.mask_ops import rle_decode, segmentation_to_mask
    from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator

    cats = sorted(gt["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    sizes = {im["id"]: (im["height"], im["width"]) for im in gt["images"]}
    gt_by_img = defaultdict(list)
    for a in gt["annotations"]:
        gt_by_img[a["image_id"]].append(a)
    pr_by_img = defaultdict(list)
    for p in preds:
        pr_by_img[p["image_id"]].append(p)

    ev = COCOMaskAPEvaluator(num_classes=len(cats))
    for img_id, (h, w) in sizes.items():
        gts = gt_by_img.get(img_id, [])
        prs = pr_by_img.get(img_id, [])
        if not gts and not prs:
            continue
        g_masks = np.stack([
            mask_to_boundary_region(segmentation_to_mask(a["segmentation"], h, w),
                                    dilation_ratio) for a in gts
        ]) if gts else np.zeros((0, h, w), bool)
        p_masks = np.stack([
            mask_to_boundary_region(rle_decode(p["segmentation"]), dilation_ratio)
            for p in prs
        ]) if prs else np.zeros((0, h, w), bool)
        ev.process(
            {"image_id": img_id,
             "scores": np.asarray([p["score"] for p in prs]),
             "labels": np.asarray([id_map.get(p["category_id"], 0) for p in prs]),
             "masks": p_masks},
            {"labels": np.asarray([id_map.get(a["category_id"], 0) for a in gts]),
             "masks": g_masks,
             "iscrowd": np.asarray([a.get("iscrowd", 0) for a in gts], bool)},
        )
    return {f"Boundary{k}": round(v, 2) for k, v in ev.evaluate().items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--pred-json", required=True)
    ap.add_argument("--dilation-ratio", type=float, default=0.02)
    args = ap.parse_args(argv)

    with open(args.gt_json) as f:
        gt = json.load(f)
    with open(args.pred_json) as f:
        preds = json.load(f)
    res = boundary_ap(gt, preds, args.dilation_ratio)
    print(res)
    return res


if __name__ == "__main__":
    main()
