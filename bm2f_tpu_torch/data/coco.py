"""COCO-format dataset loading (replacement for detectron2's
load_coco_json / pycocotools usage in the reference's
data/datasets/register_*.py). Pure-python json parsing; no pycocotools."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
) -> List[dict]:
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            json_file=json_file,
            image_root=image_root,
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
        )

    anns_by_img = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_img[ann["image_id"]].append(ann)

    out = []
    for img in coco.get("images", []):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "annotations": [
                {
                    "bbox": a.get("bbox"),
                    "category_id": id_map.get(a["category_id"], a["category_id"]),
                    "segmentation": a.get("segmentation"),
                    "iscrowd": a.get("iscrowd", 0),
                    "area": a.get("area", 0),
                }
                for a in anns_by_img.get(img["id"], [])
            ],
        }
        out.append(record)
    return out


def register_coco_instances(name: str, json_file: str, image_root: str):
    """detectron2-style registration (reference:
    mask2former_video/data_video/datasets/ytvis.py:271 analogue for images)."""
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco"
    )


def load_coco_panoptic_json(
    json_file: str, image_root: str, panoptic_root: str,
    dataset_name: Optional[str] = None,
) -> List[dict]:
    """COCO panoptic format: one png per image + segments_info."""
    with open(json_file) as f:
        pan = json.load(f)
    cats = sorted(pan.get("categories", []), key=lambda c: c["id"])
    thing_map, stuff_map, contiguous = {}, {}, {}
    for i, c in enumerate(cats):
        contiguous[c["id"]] = i
        if c.get("isthing", 0):
            thing_map[c["id"]] = i
        else:
            stuff_map[c["id"]] = i
    if dataset_name:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            thing_dataset_id_to_contiguous_id=thing_map,
            stuff_dataset_id_to_contiguous_id=stuff_map,
            dataset_id_to_contiguous_id=contiguous,
            thing_classes=[c["name"] for c in cats if c.get("isthing", 0)],
            stuff_classes=[c["name"] for c in cats],
            panoptic_root=panoptic_root,
            image_root=image_root,
        )

    out = []
    for ann in pan["annotations"]:
        fname = ann["file_name"]
        out.append(
            {
                "file_name": os.path.join(
                    image_root, fname.replace(".png", ".jpg")
                ),
                "image_id": ann["image_id"],
                "pan_seg_file_name": os.path.join(panoptic_root, fname),
                "segments_info": [
                    {
                        "id": s["id"],
                        "category_id": contiguous.get(
                            s["category_id"], s["category_id"]
                        ),
                        "iscrowd": s.get("iscrowd", 0),
                        "isthing": s["category_id"] in thing_map,
                    }
                    for s in ann["segments_info"]
                ],
            }
        )
    return out


def register_coco_panoptic(
    name: str, json_file: str, image_root: str, panoptic_root: str
):
    DatasetCatalog.register(
        name, lambda: load_coco_panoptic_json(json_file, image_root, panoptic_root, name)
    )
    MetadataCatalog.get(name).set(evaluator_type="coco_panoptic_seg")
