"""Offline ground-truth converter: ADE20K instance segmentation as a
COCO-format instances JSON (reference: datasets/prepare_ade20k_ins_seg.py,
as the JAX package's tools/prepare_ade20k_ins_seg.py writes it). Reads the
SceneParsing `annotations_instance` PNGs (R channel = thing-class id
1..100, G channel = instance id within the image) and writes
ade20k_instance_{train,val}.json with compressed-RLE masks.

    python -m bm2f_tpu_torch.tools.prepare_ade20k_ins_seg \\
        [--dataset-root $DETECTRON2_DATASETS/ADEChallengeData2016]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
from PIL import Image

from bm2f_tpu_torch.data.mask_ops import mask_to_box, rle_encode


def convert_split(ann_dir: str):
    """(images, annotations, categories) of one split's instance PNGs."""
    images, annotations = [], []
    ann_id = 1
    cat_ids = set()
    for i, f in enumerate(sorted(glob.glob(os.path.join(ann_dir, "*.png")))):
        stem = os.path.splitext(os.path.basename(f))[0]
        arr = np.asarray(Image.open(f))
        h, w = arr.shape[:2]
        images.append({"id": i + 1, "file_name": stem + ".jpg", "height": h, "width": w})
        cls = arr[..., 0].astype(np.int32)
        inst = arr[..., 1].astype(np.int32)
        for cid in np.unique(cls):
            if cid == 0:
                continue
            sel = cls == cid
            for iid in np.unique(inst[sel]):
                m = (sel & (inst == iid)).astype(np.uint8)
                if m.sum() < 1:
                    continue
                x0, y0, x1, y1 = mask_to_box(m)
                annotations.append({
                    "id": ann_id, "image_id": i + 1,
                    "category_id": int(cid),
                    "segmentation": rle_encode(m),
                    "area": int(m.sum()),
                    "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                    "iscrowd": 0,
                })
                ann_id += 1
                cat_ids.add(int(cid))
    categories = [{"id": c, "name": f"ade_thing_{c}"} for c in sorted(cat_ids)]
    return images, annotations, categories


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-root", default=os.path.join(
        os.environ.get("DETECTRON2_DATASETS", "datasets"), "ADEChallengeData2016"))
    args = ap.parse_args(argv)

    for split, sdir in (("train", "training"), ("val", "validation")):
        ann_dir = os.path.join(args.dataset_root, "annotations_instance", sdir)
        if not os.path.isdir(ann_dir):
            print(f"skip {split}: {ann_dir} missing")
            continue
        images, annotations, categories = convert_split(ann_dir)
        out_path = os.path.join(args.dataset_root, f"ade20k_instance_{split}.json")
        with open(out_path, "w") as fp:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, fp)
        print(f"{split}: {len(images)} images, {len(annotations)} instances -> {out_path}")


if __name__ == "__main__":
    main()
