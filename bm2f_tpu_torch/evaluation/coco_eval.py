"""COCO-protocol average precision, implemented natively (pycocotools is not
in this environment). Replaces the reference's COCOEvaluator /
InstanceSegEvaluator (reference: mask2former/evaluation/instance_evaluation.py:30,
which merely relaxes contiguous-id checks on top of pycocotools logic).

Protocol (COCO spec): IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision, per-category then averaged; area ranges all/small/medium/large;
maxDets=100; crowd GTs are ignore-regions that absorb otherwise-unmatched
predictions.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def mask_iou_matrix(
    pred_masks: np.ndarray, gt_masks: np.ndarray, gt_iscrowd: Sequence[bool]
) -> np.ndarray:
    """(P, H, W) x (G, H, W) -> (P, G) IoU; crowd GT uses pred area as denom."""
    P, G = len(pred_masks), len(gt_masks)
    if P == 0 or G == 0:
        return np.zeros((P, G), np.float64)
    pf = pred_masks.reshape(P, -1).astype(np.float64)
    gf = gt_masks.reshape(G, -1).astype(np.float64)
    inter = pf @ gf.T
    pa = pf.sum(1)[:, None]
    ga = gf.sum(1)[None, :]
    union = pa + ga - inter
    crowd = np.asarray(gt_iscrowd, bool)[None, :]
    denom = np.where(crowd, pa, union)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-9), 0.0)


def _match_image(
    iou: np.ndarray,
    pred_scores: np.ndarray,
    gt_ignore: np.ndarray,
    gt_iscrowd: np.ndarray,
    thr: float,
):
    """Greedy score-descending matching at one IoU threshold.
    Returns (pred_matched_gt (P,), pred_ignore (P,))."""
    P, G = iou.shape
    order = np.argsort(-pred_scores, kind="stable")
    # visit non-ignore GTs first so a real match is preferred over an
    # ignore-region match at equal-or-better IoU (pycocotools convention)
    gt_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
    gt_taken = np.zeros(G, bool)
    pred_match = np.full(P, -1, np.int64)
    pred_ignore = np.zeros(P, bool)
    for pi in order:
        best, best_iou = -1, min(thr, 1 - 1e-10)
        for gi in gt_order:
            if gt_taken[gi] and not gt_iscrowd[gi]:
                continue
            # once matched to a real GT, never switch to an ignore GT
            if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                break
            if iou[pi, gi] < best_iou:
                continue
            best, best_iou = gi, iou[pi, gi]
        if best >= 0:
            pred_match[pi] = best
            pred_ignore[pi] = gt_ignore[best]
            if not gt_iscrowd[best]:
                gt_taken[best] = True
    return pred_match, pred_ignore


class COCOMaskAPEvaluator:
    """DatasetEvaluator-protocol AP evaluator over binary masks (or boxes).

    process() consumes per-image predictions:
      {"image_id", "scores" (N,), "labels" (N,), "masks" (N,H,W) bool}
    and ground truth:
      {"labels" (G,), "masks" (G,H,W), "iscrowd" (G,)}
    """

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        self._entries = defaultdict(list)  # cat -> list of per-image records

    def state_dict(self):
        return dict(self._entries)

    def merge_state(self, state):
        """Fold another process's accumulated records in (multi-host eval,
        reference: ytvis_eval.py:120-126 comm.gather)."""
        for c, recs in state.items():
            self._entries[c].extend(recs)

    def process(self, pred: Dict, gt: Dict):
        scores = np.asarray(pred["scores"])
        labels = np.asarray(pred["labels"])
        masks = np.asarray(pred["masks"])
        order = np.argsort(-scores, kind="stable")[: self.max_dets]
        scores, labels, masks = scores[order], labels[order], masks[order]

        g_labels = np.asarray(gt["labels"])
        g_masks = np.asarray(gt["masks"])
        g_crowd = np.asarray(gt.get("iscrowd", np.zeros(len(g_labels), bool))).astype(bool)
        # explicit areas override the mask-sum default (YTVIS tracks use
        # mean-area-over-present-frames for the small/medium/large ranges)
        if gt.get("areas") is not None:
            g_areas = np.asarray(gt["areas"], np.float64)
        else:
            g_areas = g_masks.reshape(len(g_masks), -1).sum(1) if len(g_masks) else np.zeros(0)
        if pred.get("areas") is not None:
            p_areas = np.asarray(pred["areas"], np.float64)[order]
        else:
            p_areas = masks.reshape(len(masks), -1).sum(1) if len(masks) else np.zeros(0)

        for c in np.union1d(np.unique(labels), np.unique(g_labels)).astype(int):
            pi = labels == c
            gi = g_labels == c
            iou = mask_iou_matrix(masks[pi], g_masks[gi], g_crowd[gi])
            self._entries[c].append(
                {
                    "scores": scores[pi],
                    "iou": iou,
                    "gt_crowd": g_crowd[gi],
                    "gt_area": g_areas[gi],
                    "pred_area": p_areas[pi],
                }
            )

    def evaluate(self) -> Dict[str, float]:
        results = {}
        ap_matrix = {}  # (area, thr_idx) -> list of per-cat AP
        for area, (lo, hi) in AREA_RANGES.items():
            per_cat = []
            for c, recs in self._entries.items():
                ap_t = self._category_ap(recs, lo, hi)
                if ap_t is not None:
                    per_cat.append(ap_t)  # (T,)
            if per_cat:
                m = np.stack(per_cat)  # (C, T)
                ap_matrix[area] = m
        if "all" in ap_matrix:
            m = ap_matrix["all"]
            results["AP"] = 100 * m.mean()
            results["AP50"] = 100 * m[:, 0].mean()
            results["AP75"] = 100 * m[:, 5].mean()
        for area in ("small", "medium", "large"):
            if area in ap_matrix:
                results[f"AP{area[0]}"] = 100 * ap_matrix[area].mean()
        return results

    def _category_ap(self, recs: List[dict], lo: float, hi: float) -> Optional[np.ndarray]:
        """AP at each IoU threshold for one category + area range."""
        T = len(IOU_THRS)
        all_scores, all_tp, all_ign = [], [], []
        n_gt = 0
        for r in recs:
            g_ignore = r["gt_crowd"] | (r["gt_area"] < lo) | (r["gt_area"] > hi)
            n_gt += int((~g_ignore).sum())
            P = len(r["scores"])
            if P == 0:
                continue
            p_out_of_area = (r["pred_area"] < lo) | (r["pred_area"] > hi)
            # LVIS federated protocol: unmatched detections on images whose
            # annotation is known-incomplete for this category are ignored,
            # not false positives (lvis_eval.LVISMaskAPEvaluator sets "nel")
            unmatched_ignored = p_out_of_area | bool(r.get("nel", False))
            tp = np.zeros((T, P), bool)
            ign = np.zeros((T, P), bool)
            for ti, thr in enumerate(IOU_THRS):
                match, mign = _match_image(
                    r["iou"], r["scores"], g_ignore, r["gt_crowd"], thr
                )
                tp[ti] = (match >= 0) & ~mign
                # unmatched predictions outside the area range are ignored
                ign[ti] = mign | ((match < 0) & unmatched_ignored)
            all_scores.append(r["scores"])
            all_tp.append(tp)
            all_ign.append(ign)
        if n_gt == 0:
            return None
        if not all_scores:
            return np.zeros(T)
        scores = np.concatenate(all_scores)
        tp = np.concatenate(all_tp, axis=1)
        ign = np.concatenate(all_ign, axis=1)
        order = np.argsort(-scores, kind="mergesort")
        tp, ign = tp[:, order], ign[:, order]

        ap = np.zeros(T)
        for ti in range(T):
            keep = ~ign[ti]
            tps = np.cumsum(tp[ti][keep])
            fps = np.cumsum(~tp[ti][keep])
            recall = tps / n_gt
            precision = tps / np.maximum(tps + fps, 1e-9)
            # make precision monotone (pycocotools envelope)
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            # 101-point interpolation
            if len(precision) == 0:
                ap[ti] = 0.0
                continue
            idx = np.searchsorted(recall, RECALL_THRS, side="left")
            prec_at = np.where(
                idx < len(precision),
                precision[np.minimum(idx, len(precision) - 1)],
                0.0,
            )
            ap[ti] = prec_at.mean()
        return ap
