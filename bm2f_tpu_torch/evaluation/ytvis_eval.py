"""YouTubeVIS track-AP evaluation (reference:
mask2former_video/data_video/ytvis_eval.py YTVISEvaluator + vendored
ytvis_api/ytvoseval.py: video-level AP where a track's IoU sums per-frame
intersections/unions over the whole video, :203 iou_seq): the port's copy of
the JAX package's `evaluation/ytvis_eval.py`, numpy on the host.

Built on the same COCO-protocol machinery as the image evaluator: a track
(T, H, W) is one flattened mask, which makes mask IoU exactly the
summed-over-frames track IoU."""

from __future__ import annotations

from typing import Dict

import numpy as np

from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator


class YTVISEvaluator(COCOMaskAPEvaluator):
    """process() consumes one video at a time:
      pred: {"scores" (N,), "labels" (N,), "masks" (N, T, H, W) bool}
      gt:   {"labels" (G,), "masks" (G, T, H, W), "iscrowd" (G,)}
    Track area (for the area ranges) is the mean per-frame area over frames
    where the object appears (ytvis convention: areas averaged over
    present frames)."""

    def process(self, pred: Dict, gt: Dict):
        p_masks = np.asarray(pred["masks"])
        g_masks = np.asarray(gt["masks"])
        N = p_masks.shape[0]
        G = g_masks.shape[0]
        super().process(
            {
                "image_id": pred.get("video_id", 0),
                "scores": np.asarray(pred["scores"]),
                "labels": np.asarray(pred["labels"]),
                "masks": p_masks.reshape(N, -1) if N else p_masks.reshape(0, 1),
                "areas": _track_area(p_masks),
            },
            {
                "labels": np.asarray(gt["labels"]),
                "masks": g_masks.reshape(G, -1) if G else g_masks.reshape(0, 1),
                "iscrowd": np.asarray(gt.get("iscrowd", np.zeros(G, bool))),
                "areas": _track_area(g_masks),
            },
        )


def _track_area(masks: np.ndarray) -> np.ndarray:
    """ytvis area convention for the small/medium/large AP ranges: a
    track's area is its MEAN per-frame area over the frames where the
    object appears (ytvis_api annotation areas; vendored ytvoseval uses
    the json 'areas' averaged over non-None frames). masks: (N, T, H, W)."""
    if masks.shape[0] == 0:
        return np.zeros(0)
    per_frame = masks.reshape(*masks.shape[:2], -1).sum(-1)  # (N, T)
    present = per_frame > 0
    denom = np.maximum(present.sum(-1), 1)
    return per_frame.sum(-1) / denom
