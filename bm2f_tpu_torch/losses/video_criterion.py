"""The video set criterion (reference: mask2former_video/modeling/criterion.py:144
`VideoSetCriterion`, matcher.py:503 `VideoHungarianMatcher`), as the JAX
package computes it (bm2f_tpu/losses/video_criterion.py):

- the matcher's points are drawn once per clip and sampled in every frame,
  and its costs are taken over (point, frame): one clip-level assignment;
- the mask losses take (instance, frame) pairs as their masks, with points
  drawn per frame, while `num_masks` stays the count of instances;
- `num_masks` and the class CE's weight sums are the global batch's, as in
  the image criterion (`deep_supervision`, the loop both share);
- as in the image criterion, the mask losses take the occupied slots only
  (`criterion.occupied_slots`), their matched masks chosen by (layer,
  clip, query) row (`criterion.matched_masks`), every layer's at once.

Every random point comes in through `points`, as `draw_points(cfg, L, B,
generator, frames=T)` gives them, so that the tests can hand the criterion
the JAX package's own draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from bm2f_tpu_torch.losses.criterion import (
    SetCriterionConfig,
    matched_masks,
    occupied_slots,
    point_mask_losses,
)
from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import class_cost, pad_costs, point_costs
from bm2f_tpu_torch.ops.sampling import point_sample


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
    G = tgt_labels.shape[1]
    c_class = class_cost(pred_logits, tgt_labels)

    def points(clip: torch.Tensor, n: int) -> torch.Tensor:
        """(B, H, W, n*T) -> (B, P*T, n), point-major over (point, frame)."""
        pts = point_sample(clip, coords).reshape(B, -1, n, T)  # (B, P, n, T)
        return pts.permute(0, 1, 3, 2).reshape(B, -1, n)

    pred_pts = points(clip_channels_last(pred_masks.float()), Q)
    c_mask, c_dice = point_costs(pred_pts, points(tgt_clip, G))
    C = cost_class * c_class + cost_mask * c_mask + cost_dice * c_dice
    return pad_costs(C, tgt_valid)


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
    tgt = targets["masks"].float()
    tgt_clip = clip_channels_last(tgt).contiguous()

    def layer_costs(i, logits, masks):
        return video_matcher_costs(
            logits, masks, tgt_labels, tgt_clip, tgt_valid, points["match"][i],
            cost_class=cfg.class_weight, cost_mask=cfg.mask_weight, cost_dice=cfg.dice_weight)

    def step_targets(assignment):
        nonlocal tgt_clip
        tgt_clip = None  # the matching is done: free the clip-major copy
        n_valid, occupied = occupied_slots(tgt_valid)
        tgt_frames = frame_major(tgt[:, :occupied]).contiguous()  # (B*T, Hg, Wg, G')
        B, T = tgt.shape[0], tgt.shape[2]
        # the validity weights of the (b, t, g) rows
        valid = tgt_valid[:, None, :occupied].expand(B, T, occupied).reshape(-1).float()
        # the matched (instance, frame) masks of the occupied slots of every
        # layer, on points drawn per frame; `num_masks` counts the instances
        src = matched_masks(outputs, assignment[:, :, :occupied]).float()  # (L+1, B, G', T, h, w)
        sums = point_mask_losses(frame_major(src.flatten(0, 1)).unflatten(0, (-1, B * T)),
                                 tgt_frames, valid, cfg, points["cand"], points["rand"])

        def layer_losses(i, masks, asg, num_masks, _):
            return {name: s[i] / num_masks for name, s in sums.items()}

        return StepTargets(layer_losses, n_valid, point_slots=B * occupied)

    return deep_supervision(outputs, tgt_labels, tgt_valid, cfg, assign_fn, layer_costs,
                            step_targets, cfg.loss_weights)
