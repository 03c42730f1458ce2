"""A seeded synthetic dataset in the COCO formats, laid out as the builtin
registrations expect it under `$DETECTRON2_DATASETS`
(`data/datasets/builtin.py`), so that the eval runs end to end with no
download:

  coco/val2017/<id>.jpg                        images
  coco/annotations/instances_val2017.json      instances: compressed RLE
                                               masks, and one crowd region
                                               an image (uncompressed RLE)
  coco/annotations/panoptic_val2017.json       panoptic segments_info
  coco/panoptic_val2017/<id>.png               panoptic id PNGs
  ADEChallengeData2016/images/validation/<id>.jpg
  ADEChallengeData2016/annotations_detectron2/validation/<id>.png
                                               semantic labels, 255 ignored

which registers `coco_2017_val` (evaluator "coco"), `coco_2017_val_panoptic`
("coco_panoptic_seg") and `ade20k_sem_seg_val` ("sem_seg"). Images are
JPEG because the panoptic and ADE20K layouts name them `.jpg`
(`data/coco.py` maps a panoptic PNG's name to its image's).

Each image holds a few rectangles and ellipses: `THINGS` thing classes
(instances) over `STUFF` stuff classes, one thing region marked crowd, a
void strip along the top (panoptic id 0, semantic 255). Pixels are a colour
per segment plus noise.

    python -m bm2f_tpu_torch.data.synthetic --root DIR [--sizes 480x640 ...]
        [--seed 0]

`--sizes` are HxW.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from bm2f_tpu_torch.data.mask_ops import rle_encode
from bm2f_tpu_torch.data.panoptic_io import write_panoptic_png

THINGS, STUFF = 5, 3
# COCO val2017 sizes (H x W): the eval's 800 / 1333 resize puts the four
# landscape and portrait ones in its 1344 bucket and the three square ones in
# its 992 bucket (two a bucket at least, so that each has a warm image)
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500), (800, 800), (640, 640),
              (612, 612))


def _categories() -> List[dict]:
    return [{"id": i + 1, "name": f"{'thing' if i < THINGS else 'stuff'}_{i}",
             "isthing": int(i < THINGS)} for i in range(THINGS + STUFF)]


def _image(rng: np.random.RandomState, h: int, w: int):
    """(pixels (h, w, 3) uint8, panoptic ids (h, w), segments)."""
    pan = np.zeros((h, w), np.int64)
    segments = []
    yy, xx = np.mgrid[:h, :w]
    sid = 0
    # stuff: horizontal bands under the void strip
    bands = np.linspace(h // 16, h, STUFF + 1).astype(int)
    for k in range(STUFF):
        sid += 1
        pan[bands[k]:bands[k + 1]] = sid
        segments.append({"id": sid, "category_id": THINGS + k + 1, "iscrowd": 0})
    # things: rectangles and ellipses, the last one a crowd region
    n_things = rng.randint(2, 5)
    for t in range(n_things):
        sid += 1
        y0, x0 = rng.randint(h // 16, h * 3 // 4), rng.randint(0, w * 3 // 4)
        bh, bw = rng.randint(h // 10, h // 3), rng.randint(w // 10, w // 3)
        if t % 2:
            cy, cx = y0 + bh / 2, x0 + bw / 2
            region = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1
        else:
            region = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
        pan[region] = sid
        segments.append({"id": sid, "category_id": int(rng.randint(1, THINGS + 1)),
                         "iscrowd": int(t == n_things - 1)})
    segments = [s for s in segments if (pan == s["id"]).any()]
    colours = rng.randint(0, 256, (sid + 1, 3))
    pixels = colours[pan] + rng.randint(-20, 21, (h, w, 3))
    return np.clip(pixels, 0, 255).astype(np.uint8), pan, segments


def write_synthetic_coco(root: str, sizes: Sequence[Tuple[int, int]] = COCO_SIZES,
                         seed: int = 0) -> Dict[str, str]:
    """Writes the dataset under `root`; returns {dataset name: evaluator
    type} of what `register_all_builtin_datasets(root)` will register."""
    rng = np.random.RandomState(seed)
    coco = os.path.join(root, "coco")
    ade = os.path.join(root, "ADEChallengeData2016")
    dirs = {"img": os.path.join(coco, "val2017"), "ann": os.path.join(coco, "annotations"),
            "pan": os.path.join(coco, "panoptic_val2017"),
            "ade_img": os.path.join(ade, "images", "validation"),
            "ade_sem": os.path.join(ade, "annotations_detectron2", "validation")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cats = _categories()
    images, instances, panoptic = [], [], []
    for image_id, (h, w) in enumerate(sizes, start=1):
        pixels, pan, segments = _image(rng, h, w)
        name = f"{image_id:012d}"
        for d in (dirs["img"], dirs["ade_img"]):
            Image.fromarray(pixels).save(os.path.join(d, name + ".jpg"), quality=95)
        write_panoptic_png(os.path.join(dirs["pan"], name + ".png"), pan)
        sem = np.full((h, w), 255, np.uint8)
        for s in segments:
            sem[pan == s["id"]] = s["category_id"] - 1  # contiguous ids
        Image.fromarray(sem).save(os.path.join(dirs["ade_sem"], name + ".png"))
        images.append({"id": image_id, "file_name": name + ".jpg", "height": h, "width": w})
        panoptic.append({"image_id": image_id, "file_name": name + ".png",
                         "segments_info": segments})
        for s in segments:
            if s["category_id"] > THINGS:
                continue
            m = (pan == s["id"]).astype(np.uint8)
            rle = rle_encode(m)
            if s["iscrowd"]:  # crowd regions as uncompressed RLE, as COCO has them
                flat = m.T.reshape(-1)
                change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
                counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
                rle = {"size": [h, w], "counts": ([0] if flat[0] else []) + counts}
            ys, xs = np.nonzero(m)
            instances.append({
                "id": len(instances) + 1, "image_id": image_id,
                "category_id": s["category_id"], "segmentation": rle,
                "area": int(m.sum()), "iscrowd": s["iscrowd"],
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)]})
    with open(os.path.join(dirs["ann"], "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": instances,
                   "categories": [{k: c[k] for k in ("id", "name")} for c in cats]}, f)
    with open(os.path.join(dirs["ann"], "panoptic_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": panoptic, "categories": cats}, f)
    return {"coco_2017_val": "coco", "coco_2017_val_panoptic": "coco_panoptic_seg",
            "ade20k_sem_seg_val": "sem_seg"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--sizes", nargs="+", default=None, metavar="HxW")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sizes = (COCO_SIZES if args.sizes is None
             else [tuple(int(v) for v in s.split("x")) for s in args.sizes])
    for name, etype in write_synthetic_coco(args.root, sizes, args.seed).items():
        print(f"{name} ({etype})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
