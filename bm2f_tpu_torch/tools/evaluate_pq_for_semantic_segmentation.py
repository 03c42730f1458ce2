"""PQ of semantic-segmentation outputs (reference:
tools/evaluate_pq_for_semantic_segmentation.py, as the JAX package writes
it): each class map becomes one segment per class present (semantic PQ),
scored by the port's panoptic evaluator. Inputs: directories of predicted
and ground-truth class PNGs of the same names.

    python -m bm2f_tpu_torch.tools.evaluate_pq_for_semantic_segmentation \\
        --pred-dir PRED --gt-dir GT --num-classes 150 [--num-stuff N]

Class ids at or above --num-classes are void. As the JAX tool does, the
classes below --num-stuff are the things (`thing_mask[i] = i <
num_stuff`), whatever the flag's name says (ROADMAP §3).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
from PIL import Image

from bm2f_tpu_torch.evaluation.panoptic_eval import PanopticEvaluator


def class_map_to_segments(seg: np.ndarray, num_classes: int):
    """One segment per class present (semantic PQ convention)."""
    ids = np.full(seg.shape, -1, np.int64)
    infos = []
    for c in np.unique(seg):
        if c >= num_classes:
            continue
        ids[seg == c] = int(c) + 1
        infos.append({"id": int(c) + 1, "category_id": int(c)})
    return ids, infos


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--num-stuff", type=int, default=0,
                    help="classes >= this index are stuff (0 = all stuff)")
    args = ap.parse_args(argv)

    thing_mask = [i < args.num_stuff for i in range(args.num_classes)]
    ev = PanopticEvaluator(args.num_classes, thing_mask)
    for p in sorted(glob.glob(os.path.join(args.pred_dir, "*.png"))):
        g = os.path.join(args.gt_dir, os.path.basename(p))
        pred = np.asarray(Image.open(p)).astype(np.int64)
        gt = np.asarray(Image.open(g)).astype(np.int64)
        pm, pi = class_map_to_segments(pred, args.num_classes)
        gm, gi = class_map_to_segments(gt, args.num_classes)
        ev.process(pm, pi, gm, gi)
    res = ev.evaluate()
    print(res)
    return res


if __name__ == "__main__":
    main()
