"""LVIS-protocol mask AP, implemented natively on top of the COCO-protocol
machinery (reference dispatch: the reference train_net.py:126-128 builds a
d2 LVISEvaluator when evaluator_type == "lvis"; the protocol itself is the
lvis-api's LVISEval).

Differences from COCO the protocol requires (LVIS paper §4 / lvis-api):
  * maxDets = 300 per image (across categories), not 100.
  * Federated annotation: for category c, an image participates in c's
    evaluation only if c has ground truth there (positive set) or c is in
    the image's ``neg_category_ids`` (verified absent). Detections of c on
    any other image are dropped — neither TP nor FP.
  * ``not_exhaustive_category_ids``: c has GT in the image but not ALL
    instances are annotated — unmatched detections of c there are ignored
    rather than counted as false positives.
  * No crowd annotations.
  * AP is additionally reported per frequency band: APr (rare, <10 training
    images), APc (common, 10-100), APf (frequent, >100), using the
    per-category ``frequency`` field from the LVIS json.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator, mask_iou_matrix


class LVISMaskAPEvaluator(COCOMaskAPEvaluator):
    """DatasetEvaluator-protocol LVIS mask AP.

    process() consumes per-image predictions (same schema as the COCO
    evaluator) and ground truth with two extra keys:
      {"labels", "masks", "neg_categories" (sequence of contiguous ids
       verified absent), "not_exhaustive_categories" (sequence of contiguous
       ids with incomplete GT)}.
    """

    def __init__(self, num_classes: int, max_dets: int = 300,
                 frequencies: Optional[Sequence[str]] = None):
        super().__init__(num_classes, max_dets=max_dets)
        # per-contiguous-id frequency band ("r" | "c" | "f"), for APr/APc/APf
        self.frequencies = list(frequencies) if frequencies is not None else None

    def process(self, pred: Dict, gt: Dict):
        scores = np.asarray(pred["scores"])
        labels = np.asarray(pred["labels"])
        masks = np.asarray(pred["masks"])
        order = np.argsort(-scores, kind="stable")[: self.max_dets]
        scores, labels, masks = scores[order], labels[order], masks[order]

        g_labels = np.asarray(gt["labels"])
        g_masks = np.asarray(gt["masks"])
        g_areas = (
            g_masks.reshape(len(g_masks), -1).sum(1)
            if len(g_masks)
            else np.zeros(0)
        )
        p_areas = (
            masks.reshape(len(masks), -1).sum(1) if len(masks) else np.zeros(0)
        )
        neg = set(int(c) for c in gt.get("neg_categories", ()))
        nel = set(int(c) for c in gt.get("not_exhaustive_categories", ()))

        pos = set(np.unique(g_labels).astype(int).tolist())
        for c in sorted(pos | (set(np.unique(labels).astype(int)) & neg)):
            # federated protocol: images where c is neither positive nor
            # verified-negative contribute nothing to category c
            pi = labels == c
            gi = g_labels == c
            no_crowd = np.zeros(int(gi.sum()), bool)
            iou = mask_iou_matrix(masks[pi], g_masks[gi], no_crowd)
            self._entries[c].append(
                {
                    "scores": scores[pi],
                    "iou": iou,
                    "gt_crowd": no_crowd,
                    "gt_area": g_areas[gi],
                    "pred_area": p_areas[pi],
                    # unmatched detections ignored where annotation is
                    # known-incomplete for c
                    "nel": c in nel,
                }
            )

    def evaluate(self) -> Dict[str, float]:
        results = super().evaluate()
        if self.frequencies is not None:
            from bm2f_tpu_torch.evaluation.coco_eval import AREA_RANGES

            lo, hi = AREA_RANGES["all"]
            band_aps = {"r": [], "c": [], "f": []}
            for c, recs in self._entries.items():
                ap_t = self._category_ap(recs, lo, hi)
                if ap_t is None:
                    continue
                band = self.frequencies[c] if c < len(self.frequencies) else None
                if band in band_aps:
                    band_aps[band].append(ap_t.mean())
            for band, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                if band_aps[band]:
                    results[key] = 100 * float(np.mean(band_aps[band]))
        return results
