"""Host-side relabeling of the device panoptic output
(`bm2f_tpu_torch.models.maskformer.panoptic_inference`) to contiguous segment ids
+ segments_info, matching the reference's canvas semantics
(maskformer_model.py:515-571)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def relabel_panoptic(pan: Dict) -> Tuple[np.ndarray, List[Dict]]:
    """pan: dict from panoptic_inference (numpy-convertible).
    Returns (seg_map (H, W) int32 with 0 = void, segments_info)."""
    quidx = np.asarray(pan["panoptic_quidx"])
    valid = np.asarray(pan["valid"])
    classes = np.asarray(pan["classes"])
    isthing = np.asarray(pan["isthing"])
    canonical = np.asarray(pan["canonical"])

    seg_map = np.zeros(quidx.shape, np.int32)
    segments: List[Dict] = []
    next_id = 0
    # assign ids in query order (the reference's iteration order)
    remap = {}
    for q in np.where(valid)[0]:
        cq = int(canonical[q])
        if cq != q and cq in remap:
            continue  # merged into an earlier stuff segment
        next_id += 1
        remap[cq] = next_id
        segments.append(
            {
                "id": next_id,
                "isthing": bool(isthing[q]),
                "category_id": int(classes[q]),
            }
        )
    for cq, sid in remap.items():
        seg_map[quidx == cq] = sid
    return seg_map, segments
