"""Mask2Former's set criterion and Hungarian matcher in plain PyTorch, as
facebookresearch/Mask2Former writes them (modeling/criterion.py,
modeling/matcher.py), with scipy's `linear_sum_assignment`:

- the matcher, per image and layer, samples the predicted and the target
  masks at the same uniform points and costs 2 x (-p(class)) + 5 x sigmoid
  CE + 5 x dice; padding targets (`valid` False) are not matched;
- the class loss is the cross entropy over every query, "no object" for
  the unmatched ones, weighted 0.1;
- the mask losses sample each matched mask at its most uncertain
  candidates (the `importance_sample_ratio` share of the `oversample_ratio`
  x points candidates, smallest |logit| first) and at uniform points, the
  targets bilinearly at the same points (PointRend's point_sample);
- every loss of every layer is summed over masks and divided by the number
  of valid targets in the batch (at least 1).

The random points come from the caller (one draw per layer and image,
shared by the image's masks), so that the reference and the system under
test see the same points: "match" (L+1, B, N, 2), "cand" (L+1, B, 3N, 2),
"rand" (L+1, B, N/4, 2), aux layers first, coordinates (x, y) in [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment


@dataclass(frozen=True)
class LossWeights:
    num_classes: int = 80
    eos_coef: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75


def point_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """PointRend's point_sample: img (N, C, H, W), coords (N, P, 2) in [0, 1]
    -> (N, C, P)."""
    return F.grid_sample(img, 2.0 * coords[:, :, None, :] - 1.0, mode="bilinear",
                         padding_mode="zeros", align_corners=False)[..., 0]


def layers_of(outputs) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(logits, masks) of every head, aux first, the final last."""
    return list(zip(outputs["aux_logits"], outputs["aux_masks"])) + [
        (outputs["pred_logits"], outputs["pred_masks"])]


def solve(cost: torch.Tensor) -> np.ndarray:
    """(Q, G) cost -> the query of each target (G,)."""
    rows, cols = linear_sum_assignment(cost.detach().cpu().double().numpy())
    out = np.empty(cost.shape[1], np.int64)
    out[cols] = rows
    return out


@torch.no_grad()
def mask_match(logits, masks, labels, tgt_masks, coords, w: LossWeights) -> np.ndarray:
    """One image's matching: logits (Q, K+1), masks (Q, h, w), labels (G,),
    tgt_masks (G, H, W), coords (N, 2)."""
    prob = logits.float().softmax(-1)
    c_class = -prob[:, labels]
    pts = coords[None]
    out = point_sample(masks[:, None].float(), pts.expand(masks.shape[0], -1, -1))[:, 0]
    tgt = point_sample(tgt_masks[:, None].float(), pts.expand(tgt_masks.shape[0], -1, -1))[:, 0]
    n = out.shape[1]
    pos = F.binary_cross_entropy_with_logits(out, torch.ones_like(out), reduction="none")
    neg = F.binary_cross_entropy_with_logits(out, torch.zeros_like(out), reduction="none")
    c_mask = (pos @ tgt.t() + neg @ (1 - tgt).t()) / n
    p = out.sigmoid()
    c_dice = 1 - (2 * p @ tgt.t() + 1) / (p.sum(-1)[:, None] + tgt.sum(-1)[None, :] + 1)
    return solve(w.mask_weight * c_mask + w.class_weight * c_class + w.dice_weight * c_dice)


def class_loss(logits, matched, w: LossWeights):
    """Weighted CE over all queries, over the weights' sum. matched: [(b,
    query, label)]."""
    B, Q, _ = logits.shape
    target = torch.full((B, Q), w.num_classes, dtype=torch.long, device=logits.device)
    if matched:
        b, q, lab = torch.tensor(matched, dtype=torch.long).t().to(logits.device)
        target[b, q] = lab
    weight = torch.ones(w.num_classes + 1, device=logits.device)
    weight[-1] = w.eos_coef
    return F.cross_entropy(logits.float().transpose(1, 2), target, weight)


def mask_losses(src, tgt, cand, rand, num_masks, w: LossWeights):
    """src (N, h, w) matched logits, tgt (N, H, W), cand (N, 3P, 2), rand
    (N, P/4, 2) -> (sigmoid CE, dice), each summed / num_masks."""
    n_imp = int(w.importance_sample_ratio * w.num_points)
    with torch.no_grad():
        unc = -point_sample(src[:, None].float(), cand)[:, 0].abs()
        idx = unc.topk(n_imp, dim=1).indices
        coords = torch.cat([torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2)), rand], 1)
        labels = point_sample(tgt[:, None].float(), coords)[:, 0]
    logits = point_sample(src[:, None].float(), coords)[:, 0]
    ce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean(1)
    p = logits.sigmoid()
    dice = 1 - (2 * (p * labels).sum(-1) + 1) / (p.sum(-1) + labels.sum(-1) + 1)
    return ce.sum() / num_masks, dice.sum() / num_masks


def mask_criterion(outputs, targets: Mapping[str, torch.Tensor], points, w: LossWeights):
    """targets: labels (B, G), masks (B, G, H, W), valid (B, G). Returns (total, {loss_ce, loss_mask, loss_dice, loss_ce_0, ...})."""
    layers = layers_of(outputs)
    B = targets["labels"].shape[0]
    rows = [targets["valid"][b].nonzero()[:, 0] for b in range(B)]
    num_masks = max(float(sum(len(r) for r in rows)), 1.0)
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for i, (logits, masks) in enumerate(layers):
        matched, src, tgt, cand, rand = [], [], [], [], []
        for b in range(B):
            labels = targets["labels"][b, rows[b]].long()
            tmasks = targets["masks"][b, rows[b]]
            q = mask_match(logits[b], masks[b], labels, tmasks, points["match"][i, b], w)
            matched += [(b, int(qq), int(ll)) for qq, ll in zip(q, labels.tolist())]
            qi = torch.as_tensor(q, device=masks.device)
            src.append(masks[b, qi])
            tgt.append(tmasks)
            cand.append(points["cand"][i, b][None].expand(len(q), -1, -1))
            rand.append(points["rand"][i, b][None].expand(len(q), -1, -1))
        ce = class_loss(logits, matched, w)
        lm, ld = mask_losses(torch.cat(src), torch.cat(tgt), torch.cat(cand), torch.cat(rand),
                             num_masks, w)
        sfx = "" if i == len(layers) - 1 else f"_{i}"
        losses[f"loss_ce{sfx}"], losses[f"loss_mask{sfx}"], losses[f"loss_dice{sfx}"] = ce, lm, ld
        total = total + w.class_weight * ce + w.mask_weight * lm + w.dice_weight * ld
    return total, losses
