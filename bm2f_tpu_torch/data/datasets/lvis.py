"""LVIS v1 dataset loading + registration (reference: the d2
`register_lvis_instances`/`load_lvis_json` path that feeds the LVISEvaluator
branch of the reference train_net.py:126-128).

LVIS json schema notes (distinct from COCO instances):
  * images carry no "file_name"; it is derived from "coco_url"
    ("http://images.cocodataset.org/val2017/xxx.jpg" -> "val2017/xxx.jpg").
  * images carry "neg_category_ids" (verified absent) and
    "not_exhaustive_category_ids" (present but incompletely annotated) —
    both required by the federated evaluation protocol.
  * annotations have no "iscrowd"; segmentation is always polygon lists.
  * categories (1203 in v1) carry "frequency" in {"r","c","f"} for the
    APr/APc/APf breakdown; names are in "name" (synonyms in "synonyms").
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional

from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog


def _file_name_from_coco_url(url: str) -> str:
    # keep the split directory + basename: ".../val2017/000000397133.jpg"
    parts = url.rstrip("/").split("/")
    return "/".join(parts[-2:])


def load_lvis_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
) -> List[dict]:
    with open(json_file) as f:
        lvis = json.load(f)

    cats = sorted(lvis.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}

    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(
            json_file=json_file,
            image_root=image_root,
            thing_classes=[c.get("name") or c["synonyms"][0] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
            class_frequencies=[c.get("frequency", "f") for c in cats],
        )

    anns_by_img = defaultdict(list)
    for ann in lvis.get("annotations", []):
        anns_by_img[ann["image_id"]].append(ann)

    out = []
    for img in lvis.get("images", []):
        fname = img.get("file_name") or _file_name_from_coco_url(
            img["coco_url"]
        )
        record = {
            "file_name": os.path.join(image_root, fname),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "neg_category_ids": [
                id_map[c] for c in img.get("neg_category_ids", []) if c in id_map
            ],
            "not_exhaustive_category_ids": [
                id_map[c]
                for c in img.get("not_exhaustive_category_ids", [])
                if c in id_map
            ],
            "annotations": [
                {
                    "category_id": id_map[a["category_id"]],
                    "segmentation": a["segmentation"],
                    "bbox": a.get("bbox"),
                    "area": a.get("area"),
                    "iscrowd": 0,  # LVIS has no crowd annotations
                }
                for a in anns_by_img.get(img["id"], [])
                if a["category_id"] in id_map
            ],
        }
        out.append(record)
    return out


def register_lvis_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(
        name, lambda: load_lvis_json(json_file, image_root, name)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="lvis"
    )
