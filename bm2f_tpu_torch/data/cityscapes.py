"""Cityscapes loaders (replacement for detectron2's builtin cityscapes
support used by the reference's Cityscapes configs):

- instances from the gtFine *_polygons.json files (8 thing classes);
- panoptic via the cityscapesscripts-converted COCO-panoptic-format json
  (createPanopticImgs output), reusing the generic panoptic loader;
- semantic registration lives in data/datasets/builtin.py.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

# the 8 cityscapes thing classes in the standard evaluation order
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
_THING_MAP = {n: i for i, n in enumerate(CITYSCAPES_THING_CLASSES)}


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    out = []
    images = sorted(
        glob.glob(os.path.join(image_dir, "*", "*_leftImg8bit.png"))
    )
    for img_path in images:
        city = os.path.basename(os.path.dirname(img_path))
        stem = os.path.basename(img_path).replace("_leftImg8bit.png", "")
        poly_path = os.path.join(gt_dir, city, stem + "_gtFine_polygons.json")
        if not os.path.exists(poly_path):
            continue
        with open(poly_path) as f:
            gt = json.load(f)
        anns = []
        for obj in gt.get("objects", []):
            label = obj["label"]
            crowd = 0
            if label.endswith("group"):
                label = label[: -len("group")]
                crowd = 1
            if label not in _THING_MAP:
                continue
            poly = [c for pt in obj["polygon"] for c in pt]
            if len(poly) < 6:
                continue
            xs, ys = poly[0::2], poly[1::2]
            anns.append(
                {
                    "category_id": _THING_MAP[label],
                    "segmentation": [poly],
                    "bbox": [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)],
                    "iscrowd": crowd,
                }
            )
        out.append(
            {
                "file_name": img_path,
                "image_id": f"{city}_{stem}",
                "height": gt["imgHeight"],
                "width": gt["imgWidth"],
                "annotations": anns,
            }
        )
    return out


def register_all_cityscapes(root: Optional[str] = None):
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    cs = os.path.join(root, "cityscapes")
    if not os.path.isdir(cs):
        return
    for split in ("train", "val"):
        name = f"cityscapes_fine_instance_seg_{split}"
        image_dir = os.path.join(cs, "leftImg8bit", split)
        gt_dir = os.path.join(cs, "gtFine", split)
        if os.path.isdir(image_dir) and name not in DatasetCatalog:
            DatasetCatalog.register(
                name,
                lambda i=image_dir, g=gt_dir: load_cityscapes_instances(i, g),
            )
            MetadataCatalog.get(name).set(
                thing_classes=list(CITYSCAPES_THING_CLASSES),
                evaluator_type="coco",
            )
        # panoptic (COCO-panoptic-format jsons from cityscapesscripts)
        pj = os.path.join(cs, "gtFine", f"cityscapes_panoptic_{split}.json")
        pname = f"cityscapes_fine_panoptic_{split}"
        if os.path.exists(pj) and pname not in DatasetCatalog:
            from bm2f_tpu_torch.data.coco import register_coco_panoptic

            register_coco_panoptic(
                pname, pj, image_dir,
                os.path.join(cs, "gtFine", f"cityscapes_panoptic_{split}"),
            )
