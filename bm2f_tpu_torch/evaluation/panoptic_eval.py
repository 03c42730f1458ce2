"""Panoptic quality (PQ / SQ / RQ), implementing the panopticapi metric
(replaces detectron2's COCOPanopticEvaluator used by the reference trainer).

Matching rule: predicted and GT segments match iff IoU > 0.5 (computed over
the void-excluded area); PQ = sum(IoU of TP) / (TP + FP/2 + FN/2).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

VOID = -1


class PanopticEvaluator:
    def __init__(self, num_classes: int, thing_mask: Sequence[bool]):
        self.num_classes = num_classes
        self.thing_mask = np.asarray(thing_mask, bool)
        self.reset()

    def reset(self):
        self._iou = np.zeros(self.num_classes)
        self._tp = np.zeros(self.num_classes, np.int64)
        self._fp = np.zeros(self.num_classes, np.int64)
        self._fn = np.zeros(self.num_classes, np.int64)

    def state_dict(self):
        return {"iou": self._iou, "tp": self._tp, "fp": self._fp, "fn": self._fn}

    def merge_state(self, state):
        self._iou += state["iou"]
        self._tp += state["tp"]
        self._fp += state["fp"]
        self._fn += state["fn"]

    def process(
        self,
        pred_map: np.ndarray,
        pred_segments: List[Dict],
        gt_map: np.ndarray,
        gt_segments: List[Dict],
    ):
        """maps: (H, W) int segment ids (VOID = unlabeled);
        segments: [{"id", "category_id"}] (+"iscrowd" for GT)."""
        pred_cat = {s["id"]: s["category_id"] for s in pred_segments}
        gt_cat = {s["id"]: s["category_id"] for s in gt_segments}
        gt_crowd = {s["id"] for s in gt_segments if s.get("iscrowd", 0)}

        pm = pred_map.reshape(-1).astype(np.int64)
        gm = gt_map.reshape(-1).astype(np.int64)

        # areas and intersections via a single 1D bincount over paired ids
        pred_area = dict(zip(*np.unique(pm, return_counts=True)))
        gt_area = dict(zip(*np.unique(gm, return_counts=True)))
        pair = (gm + 1) * (pm.max() + 2) + (pm + 1)
        pair_ids, pair_counts = np.unique(pair, return_counts=True)
        inter = {}
        base = pm.max() + 2
        for pid, cnt in zip(pair_ids, pair_counts):
            g = pid // base - 1
            p = pid % base - 1
            inter[(g, p)] = cnt

        matched_gt, matched_pred = set(), set()
        for (g, p), i in inter.items():
            if g == VOID or p == VOID or g in gt_crowd:
                continue
            if gt_cat.get(g) != pred_cat.get(p):
                continue
            union = (
                gt_area[g] + pred_area[p] - i
                - inter.get((VOID, p), 0)  # pred area overlapping GT void
            )
            iou = i / max(union, 1)
            if iou > 0.5:
                c = gt_cat[g]
                self._tp[c] += 1
                self._iou[c] += iou
                matched_gt.add(g)
                matched_pred.add(p)

        for g, cat in gt_cat.items():
            if g in matched_gt or g in gt_crowd:
                continue
            self._fn[cat] += 1
        for p, cat in pred_cat.items():
            if p in matched_pred:
                continue
            # FP unless mostly void/crowd-covered (panopticapi rule)
            void_crowd = inter.get((VOID, p), 0)
            for g in gt_crowd:
                if gt_cat.get(g) == cat:
                    void_crowd += inter.get((g, p), 0)
            if void_crowd / max(pred_area.get(p, 1), 1) > 0.5:
                continue
            self._fp[cat] += 1

    def evaluate(self) -> Dict[str, float]:
        out = {}
        for name, mask in (
            ("", np.ones(self.num_classes, bool)),
            ("_th", self.thing_mask),
            ("_st", ~self.thing_mask),
        ):
            tp, fp, fn, iou = (
                self._tp[mask], self._fp[mask], self._fn[mask], self._iou[mask]
            )
            valid = (tp + fp + fn) > 0
            n = int(valid.sum())
            if n == 0:
                out[f"PQ{name}"] = out[f"SQ{name}"] = out[f"RQ{name}"] = 0.0
                continue
            sq = np.where(tp > 0, iou / np.maximum(tp, 1), 0.0)
            rq = tp / np.maximum(tp + 0.5 * fp + 0.5 * fn, 1e-9)
            pq = sq * rq
            out[f"PQ{name}"] = 100 * float(pq[valid].mean())
            out[f"SQ{name}"] = 100 * float(sq[valid].mean())
            out[f"RQ{name}"] = 100 * float(rq[valid].mean())
        return out
