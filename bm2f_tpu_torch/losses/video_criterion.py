"""The video set criterion (reference: mask2former_video/modeling/criterion.py:144
`VideoSetCriterion`, matcher.py:503 `VideoHungarianMatcher`), as the JAX
package computes it (bm2f_tpu/losses/video_criterion.py):

- the matcher's points are drawn once per clip and sampled in every frame,
  and its costs are taken over (point, frame): one clip-level assignment;
- the mask losses take (instance, frame) pairs as their masks, with points
  drawn per frame, while `num_masks` stays the count of instances;
- `num_masks` and the class CE's weight sums are the global batch's
  (`criterion.label_denominators`), as in the image criterion.

Every random point comes in through `points`, as `draw_points(cfg, L, B,
generator, frames=T)` gives them, so that the tests can hand the criterion
the JAX package's own draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from bm2f_tpu_torch.losses.criterion import (
    SetCriterionConfig,
    _loss_labels,
    count_targets,
    label_denominators,
    point_mask_losses,
)
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import PAD_COST, point_costs
from bm2f_tpu_torch.ops.sampling import point_sample
from bm2f_tpu_torch.utils import tracing


def clip_channels_last(masks: torch.Tensor) -> torch.Tensor:
    """(B, N, T, H, W) -> (B, H, W, N*T), channels ordered (n, t)."""
    B, N, T, H, W = masks.shape
    return masks.reshape(B, N * T, H, W).permute(0, 2, 3, 1)


def frame_major(masks: torch.Tensor) -> torch.Tensor:
    """(B, N, T, H, W) -> (B*T, H, W, N): one image a frame."""
    B, N, T, H, W = masks.shape
    return masks.permute(0, 2, 3, 4, 1).reshape(B * T, H, W, N)


@torch.no_grad()
def video_matcher_costs(
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    pred_masks: torch.Tensor,  # (B, Q, T, h, w) logits
    tgt_labels: torch.Tensor,  # (B, G)
    tgt_clip: torch.Tensor,  # (B, Hg, Wg, G*T) 0/1, `clip_channels_last`
    tgt_valid: torch.Tensor,  # (B, G) bool
    coords: torch.Tensor,  # (B, P, 2) uniform points, shared by the frames
    *,
    cost_class: float = 2.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
) -> torch.Tensor:
    """The (B, Q, G) clip-level matching costs: the class cost, and the
    sigmoid-CE and dice costs over every (point, frame) of the clip."""
    B, Q, T = pred_masks.shape[:3]
    K = pred_logits.shape[-1] - 1
    G = tgt_labels.shape[1]
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels = tgt_labels.long().clamp(0, K - 1)
    c_class = -torch.gather(prob[..., :K], 2, labels[:, None, :].expand(-1, Q, -1))

    def points(clip: torch.Tensor, n: int) -> torch.Tensor:
        """(B, H, W, n*T) -> (B, P*T, n), point-major over (point, frame)."""
        pts = point_sample(clip, coords).reshape(B, -1, n, T)  # (B, P, n, T)
        return pts.permute(0, 1, 3, 2).reshape(B, -1, n)

    pred_pts = points(clip_channels_last(pred_masks.float()), Q)
    c_mask, c_dice = point_costs(pred_pts, points(tgt_clip, G))
    C = cost_class * c_class + cost_mask * c_mask + cost_dice * c_dice
    return torch.where(tgt_valid[:, None, :], C, torch.full_like(C, PAD_COST))


def video_loss_masks(pred_masks, tgt_frames, tgt_valid, assignment, num_masks, cfg,
                     cand, randc):
    """Point-sampled sigmoid CE + dice of the matched (instance, frame)
    masks. pred_masks (B, Q, T, h, w); tgt_frames (B*T, Hg, Wg, G),
    `frame_major`; cand (B*T, n_cand, 2) and randc (B*T, n_rand, 2), drawn
    per frame. The losses are summed over (instance, frame) and divided by
    `num_masks`, the instances."""
    B, Q, T, h, w = pred_masks.shape
    G = tgt_valid.shape[1]
    src = torch.gather(pred_masks, 1,
                       assignment[:, :, None, None, None].expand(B, G, T, h, w)).float()
    valid = tgt_valid[:, None, :].expand(B, T, G).reshape(B * T * G).float()  # (b, t, g)
    return point_mask_losses(frame_major(src), tgt_frames, valid, num_masks, cfg,
                             cand, randc)


def video_set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cfg: SetCriterionConfig,
    points: Mapping[str, torch.Tensor],
    assign_fn: Callable[[torch.Tensor], torch.Tensor] = assign,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: pred_logits (B, Q, K+1), pred_masks (B, Q, T, h, w) and the
    stacked aux outputs. targets: labels (B, G), masks (B, G, T, Hg, Wg) 0/1,
    valid (B, G). points: `draw_points(cfg, L+1, B, generator, frames=T)`,
    aux layers first. `assign_fn` and the tracing as in `set_criterion`. Returns
    (total_loss, {loss_ce, loss_mask, loss_dice, loss_ce_0, ...})."""
    tgt_labels, tgt_valid = targets["labels"], targets["valid"]
    n_aux = outputs["aux_logits"].shape[0]
    layers = [(outputs["aux_logits"][i], outputs["aux_masks"][i]) for i in range(n_aux)]
    layers.append((outputs["pred_logits"], outputs["pred_masks"]))
    tgt = targets["masks"].float()
    tgt_clip = clip_channels_last(tgt).contiguous()

    count_targets(tgt_valid)

    with tracing.span("train.matcher_costs"):
        costs = torch.stack([
            video_matcher_costs(
                logits, masks, tgt_labels, tgt_clip, tgt_valid, points["match"][i],
                cost_class=cfg.class_weight, cost_mask=cfg.mask_weight,
                cost_dice=cfg.dice_weight)
            for i, (logits, masks) in enumerate(layers)
        ], 1)  # (B, L+1, Q, G)
    del tgt_clip
    with tracing.span("train.assign"):
        assignment = assign_fn(costs)  # (B, L+1, G)

    with tracing.span("train.losses"):
        num_masks, labels, _ = label_denominators(layers, tgt_labels, tgt_valid, assignment, cfg)
        tgt_frames = frame_major(tgt).contiguous()
        losses: Dict[str, torch.Tensor] = {}
        ce_l, mask_l, dice_l = [], [], []
        for i, (logits, masks) in enumerate(layers):
            ce_l.append(_loss_labels(logits, *labels[i]))
            loss_mask, loss_dice = video_loss_masks(
                masks, tgt_frames, tgt_valid, assignment[:, i], num_masks, cfg,
                points["cand"][i], points["rand"][i])
            mask_l.append(loss_mask)
            dice_l.append(loss_dice)
            suffix = "" if i == len(layers) - 1 else f"_{i}"
            losses[f"loss_ce{suffix}"] = ce_l[-1]
            losses[f"loss_mask{suffix}"] = loss_mask
            losses[f"loss_dice{suffix}"] = loss_dice
        total = (cfg.class_weight * torch.stack(ce_l).sum()
                 + cfg.mask_weight * torch.stack(mask_l).sum()
                 + cfg.dice_weight * torch.stack(dice_l).sum())
    return total, losses
