"""Offline ground-truth converter: semantic-segmentation PNGs from COCO
panoptic annotations (reference:
datasets/prepare_coco_semantic_annos_from_panoptic_annos.py, as the JAX
package's tool of that name writes it): panoptic_semseg_{split}/ with
contiguous class ids, 255 = void.

    python -m bm2f_tpu_torch.tools.prepare_coco_semantic_annos_from_panoptic_annos \\
        [--dataset-root $DETECTRON2_DATASETS/coco] [--splits val2017 train2017] \\
        [--workers 8]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
from functools import partial

import numpy as np
from PIL import Image

from bm2f_tpu_torch.data.panoptic_io import read_panoptic_png


def convert_one(ann, pan_root, out_root, id_map):
    pan = read_panoptic_png(os.path.join(pan_root, ann["file_name"]))
    sem = np.full(pan.shape, 255, np.uint8)
    for seg in ann["segments_info"]:
        sem[pan == seg["id"]] = id_map[seg["category_id"]]
    Image.fromarray(sem).save(os.path.join(out_root, ann["file_name"]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-root", default=os.path.join(
        os.environ.get("DETECTRON2_DATASETS", "datasets"), "coco"))
    ap.add_argument("--splits", nargs="+", default=["val2017", "train2017"])
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    for split in args.splits:
        json_file = os.path.join(args.dataset_root, "annotations", f"panoptic_{split}.json")
        pan_root = os.path.join(args.dataset_root, f"panoptic_{split}")
        out_root = os.path.join(args.dataset_root, f"panoptic_semseg_{split}")
        os.makedirs(out_root, exist_ok=True)
        with open(json_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        id_map = {c["id"]: i for i, c in enumerate(cats)}
        fn = partial(convert_one, pan_root=pan_root, out_root=out_root, id_map=id_map)
        with mp.Pool(args.workers) as pool:
            pool.map(fn, data["annotations"])
        print(f"{split}: wrote {len(data['annotations'])} semantic pngs")


if __name__ == "__main__":
    main()
