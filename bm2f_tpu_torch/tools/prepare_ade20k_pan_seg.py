"""Offline ground-truth converter: ADE20K panoptic PNGs and JSON
(reference: datasets/prepare_ade20k_pan_seg.py, as the JAX package's
tools/prepare_ade20k_pan_seg.py writes it). Combines the 150-class
semantic maps (annotations_detectron2, from prepare_ade20k_sem_seg) with
the instance PNGs: thing pixels get one segment per instance, each stuff
class one segment; writes panopticapi-format id PNGs under
ade20k_panoptic_{train,val}/ and ade20k_panoptic_{train,val}.json.

    python -m bm2f_tpu_torch.tools.prepare_ade20k_pan_seg \\
        [--dataset-root $DETECTRON2_DATASETS/ADEChallengeData2016]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
from PIL import Image

from bm2f_tpu_torch.data.panoptic_io import write_panoptic_png


def panoptic_of(sem: np.ndarray, inst_arr, cat_seen: dict):
    """(id map, segments) of one image: `sem` its class map (255 void),
    `inst_arr` its instance PNG or None; `cat_seen` gathers each category
    seen and whether it was a thing."""
    pan = np.zeros(sem.shape, np.uint32)
    segments = []
    next_id = 1
    # things: one segment per (class, instance id)
    if inst_arr is not None:
        icls = inst_arr[..., 0].astype(np.int32)
        iid = inst_arr[..., 1].astype(np.int32)
        thing_pix = icls > 0
        for cid in np.unique(icls[thing_pix]):
            sel = icls == cid
            sem_ids = sem[sel]
            sem_id = (int(np.bincount(sem_ids[sem_ids != 255]).argmax())
                      if (sem_ids != 255).any() else -1)
            if sem_id < 0:
                continue
            for ins in np.unique(iid[sel]):
                m = sel & (iid == ins)
                pan[m] = next_id
                segments.append({"id": next_id, "category_id": sem_id,
                                 "area": int(m.sum()), "iscrowd": 0})
                cat_seen[sem_id] = True
                next_id += 1
    # stuff: the remaining labeled pixels, one segment per class
    rest = (pan == 0) & (sem != 255)
    for cid in np.unique(sem[rest]):
        m = rest & (sem == cid)
        if m.sum() == 0:
            continue
        pan[m] = next_id
        segments.append({"id": next_id, "category_id": int(cid),
                         "area": int(m.sum()), "iscrowd": 0})
        cat_seen.setdefault(int(cid), False)
        next_id += 1
    return pan, segments


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-root", default=os.path.join(
        os.environ.get("DETECTRON2_DATASETS", "datasets"), "ADEChallengeData2016"))
    args = ap.parse_args(argv)

    for split, sdir in (("train", "training"), ("val", "validation")):
        sem_dir = os.path.join(args.dataset_root, "annotations_detectron2", sdir)
        inst_dir = os.path.join(args.dataset_root, "annotations_instance", sdir)
        out_dir = os.path.join(args.dataset_root, f"ade20k_panoptic_{split}")
        if not (os.path.isdir(sem_dir) and os.path.isdir(inst_dir)):
            print(f"skip {split}: inputs missing")
            continue
        os.makedirs(out_dir, exist_ok=True)
        pan_anns = []
        cat_seen = {}
        for f in sorted(glob.glob(os.path.join(sem_dir, "*.png"))):
            stem = os.path.splitext(os.path.basename(f))[0]
            sem = np.asarray(Image.open(f)).astype(np.int32)  # 0..149, 255 void
            inst_path = os.path.join(inst_dir, stem + ".png")
            inst_arr = np.asarray(Image.open(inst_path)) if os.path.exists(inst_path) else None
            pan, segments = panoptic_of(sem, inst_arr, cat_seen)
            write_panoptic_png(os.path.join(out_dir, stem + ".png"), pan)
            pan_anns.append({"image_id": stem, "file_name": stem + ".png",
                             "segments_info": segments})
        cats = [{"id": c, "name": f"ade_{c}", "isthing": int(bool(th))}
                for c, th in sorted(cat_seen.items())]
        out_json = os.path.join(args.dataset_root, f"ade20k_panoptic_{split}.json")
        with open(out_json, "w") as fp:
            json.dump({"annotations": pan_anns, "categories": cats}, fp)
        print(f"{split}: {len(pan_anns)} panoptic pngs -> {out_dir}")


if __name__ == "__main__":
    main()
