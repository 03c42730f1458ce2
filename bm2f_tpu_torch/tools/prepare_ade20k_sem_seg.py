"""Offline ground-truth converter for ADE20K semantic segmentation
(reference: datasets/prepare_ade20k_sem_seg.py, as the JAX package's
tools/prepare_ade20k_sem_seg.py writes it): annotation ids shifted by -1
(0, unlabeled, becomes 255 = ignore) into annotations_detectron2/.

    python -m bm2f_tpu_torch.tools.prepare_ade20k_sem_seg \\
        [--dataset-root $DETECTRON2_DATASETS/ADEChallengeData2016]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
from PIL import Image


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-root", default=os.path.join(
        os.environ.get("DETECTRON2_DATASETS", "datasets"), "ADEChallengeData2016"))
    args = ap.parse_args(argv)

    for split in ("training", "validation"):
        src = os.path.join(args.dataset_root, "annotations", split)
        dst = os.path.join(args.dataset_root, "annotations_detectron2", split)
        os.makedirs(dst, exist_ok=True)
        files = sorted(glob.glob(os.path.join(src, "*.png")))
        for f in files:
            ann = np.asarray(Image.open(f)).astype(np.int32)
            out = (ann - 1).astype(np.uint8)  # 0 (unlabeled) wraps to 255
            Image.fromarray(out).save(os.path.join(dst, os.path.basename(f)))
        print(f"{split}: {len(files)} files")


if __name__ == "__main__":
    main()
