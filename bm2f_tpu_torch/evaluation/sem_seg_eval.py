"""Semantic-segmentation evaluation: mIoU / fwIoU / pACC / mACC via a
confusion matrix (replaces detectron2's SemSegEvaluator used by the
reference's trainer, train_net.py:78-86)."""

from __future__ import annotations

from typing import Dict

import numpy as np


class SemSegEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        self._conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def state_dict(self):
        return self._conf

    def merge_state(self, state):
        self._conf += state

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred, gt: (H, W) int class maps."""
        pred = np.asarray(pred).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        valid = gt != self.ignore_label
        pred, gt = pred[valid], gt[valid]
        idx = gt.astype(np.int64) * self.num_classes + pred.astype(np.int64)
        self._conf += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    def evaluate(self) -> Dict[str, float]:
        conf = self._conf.astype(np.float64)
        tp = np.diag(conf)
        gt_total = conf.sum(1)
        pred_total = conf.sum(0)
        union = gt_total + pred_total - tp
        iou = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
        acc = np.where(gt_total > 0, tp / np.maximum(gt_total, 1), np.nan)
        freq = gt_total / max(gt_total.sum(), 1)
        valid = union > 0
        return {
            "mIoU": 100 * np.nanmean(iou[valid]) if valid.any() else 0.0,
            "fwIoU": 100 * float((freq[valid] * iou[valid]).sum()),
            "pACC": 100 * float(tp.sum() / max(conf.sum(), 1)),
            "mACC": 100 * float(np.nanmean(acc[gt_total > 0])) if (gt_total > 0).any() else 0.0,
        }
