"""One served image through the reference: the network, then Mask2Former's
three inference modes (maskformer_model.py semantic_inference,
instance_inference, panoptic_inference) on the masks resized to the padded
input and cropped to the image:

- semantic: softmax(class)[:-1] x sigmoid(mask), summed over queries;
- instance: the top 100 of the Q x K class scores, each query's mask
  logits > 0, the score times the mean sigmoid inside the mask;
- panoptic: queries whose best class is real and scores above
  `object_mask_threshold`; each pixel to the kept query of the largest
  score x sigmoid; a query kept if its pixels that also have sigmoid >= 0.5
  are not empty and its share of its mask is >= `overlap_threshold`;
  segment ids 1, 2, ... in query order (every class a thing, as the served
  predictor treats them).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.model import Arch, forward
from port_bench.reference.numerics import Numerics


@torch.no_grad()
def infer(P: Mapping[str, torch.Tensor], image: np.ndarray, a: Arch, *,
          object_mask_threshold: float, overlap_threshold: float,
          numerics: Numerics = Numerics(), device="cuda") -> Dict[str, object]:
    H, W = image.shape[:2]
    d = a.size_divisibility
    ph, pw = -(-H // d) * d, -(-W // d) * d
    x = torch.zeros((1, ph, pw, 3), device=device)
    x[0, :H, :W] = torch.from_numpy(np.asarray(image, np.float32)).to(device)
    with numerics.scope():
        out = forward(P, x, a)
    logits = out["pred_logits"][0]
    masks = F.interpolate(out["pred_masks"], size=(ph, pw), mode="bilinear",
                          align_corners=False)[0, :, :H, :W]
    K = a.num_classes
    prob = logits.softmax(-1)
    semantic = torch.einsum("qk,qhw->hwk", prob[:, :-1], masks.sigmoid())

    scores, idx = prob[:, :-1].flatten().topk(min(100, prob[:, :-1].numel()))
    labels, q = idx % K, idx // K
    m = masks[q] > 0
    mscore = (masks[q].sigmoid() * m).flatten(1).sum(1) / (m.flatten(1).sum(1) + 1e-6)

    seg, segments = panoptic(prob, masks.sigmoid(), K, object_mask_threshold,
                             overlap_threshold)
    return {"pred_logits": logits, "pred_masks": out["pred_masks"][0],
            "semantic": semantic,
            "instances": {"scores": scores * mscore, "labels": labels, "masks": m},
            "panoptic": (seg, segments)}


def panoptic(prob, masks, K, object_mask_threshold, overlap_threshold
             ) -> Tuple[torch.Tensor, List[Dict]]:
    scores, labels = prob.max(-1)
    keep = (labels != K) & (scores > object_mask_threshold)
    seg = torch.zeros(masks.shape[1:], dtype=torch.int32, device=masks.device)
    segments: List[Dict] = []
    if not bool(keep.any()):
        return seg, segments
    kept = keep.nonzero()[:, 0]
    cur = masks[kept]
    owner = (scores[kept][:, None, None] * cur).argmax(0)
    for k, q in enumerate(kept.tolist()):
        own = owner == k
        mine = own & (cur[k] >= 0.5)
        area, orig, final = int(own.sum()), int((cur[k] >= 0.5).sum()), int(mine.sum())
        if area > 0 and orig > 0 and final > 0:
            if area / orig < overlap_threshold:
                continue
            seg[mine] = len(segments) + 1
            segments.append({"id": len(segments) + 1, "isthing": True,
                             "category_id": int(labels[q])})
    return seg, segments
