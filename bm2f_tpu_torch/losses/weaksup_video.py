"""Box-supervised video losses (reference: mask2former_video/modeling/
criterion_proj.py VideoSetCriterionProj, criterion_proj_spatpair.py (+ the
spatial pairwise loss), criterion_proj_spatpair_temppair.py (+ the temporal
pairwise loss on DINOv2-matched point pairs, :38-70, :269-334); matchers
matcher.py:249 / :396; patch matching utils/weaksup_utils.py:64-198), as
the JAX package computes them (bm2f_tpu/losses/weaksup_video.py).

The temporal pairs are fixed-size: `compute_temporal_pairs` gives each
(clip, target, frame pair) `num_pairs` patch pairs with a validity mask,
batched over any leading axes. Where the JAX package's order is set by its
library, the port sets it to match: the squared distance uses JAX's
expansion |a|^2 - 2 a.b + |b|^2 (not `torch.cdist`), the nearest patch is
the first maximum, and the best pairs come from a stable descending sort
(`jax.lax.top_k` puts the lower index first among ties, which every
in-box score is when the features are zero).

As in `losses/weaksup_criterion.py`, the losses are computed on the valid
targets' rows only: the same numbers as JAX's masked sums over all B x G
rows, up to summation order; and `num_masks`, the class CE's, the spatial
pairwise loss's and the temporal loss's denominators are the global
batch's, in one all-reduce a step under data parallelism
(`deep_supervision`, the loop every set criterion shares).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from bm2f_tpu_torch.losses.criterion import SetCriterionConfig
from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.losses.weaksup import projection_loss, weighted_pairwise_loss
from bm2f_tpu_torch.losses.weaksup_criterion import BOUNDS, box_mask_costs, valid_rows
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import class_cost, pad_costs
from bm2f_tpu_torch.parallel import data_size

# ---------------------------------------------------------------------------
# DINOv2 temporal pairs
# ---------------------------------------------------------------------------


def compute_temporal_pairs(
    feat_curr: torch.Tensor,  # (..., Hp, Wp, C) patch features, frame t
    feat_next: torch.Tensor,  # (..., Hp, Wp, C) frame t+1
    box_curr: torch.Tensor,  # (..., Hp, Wp) bool: the instance's box at t
    box_next: torch.Tensor,  # (..., Hp, Wp) bool
    num_pairs: int,
    lab_curr: Optional[torch.Tensor] = None,  # (..., Hp, Wp, 3) color filter
    lab_next: Optional[torch.Tensor] = None,
    color_thresh: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each patch inside the box at t matched to its nearest patch (DINO
    feature distance) inside the box at t+1, optionally kept only where
    their LAB colors are similar; the `num_pairs` best matches. The leading
    axes of the features and of the boxes broadcast. Returns (pairs (...,
    num_pairs, 4) int32 [x_t, y_t, x_t1, y_t1] in patch coordinates, valid
    (..., num_pairs) bool)."""
    Hp, Wp, C = feat_curr.shape[-3:]
    N = Hp * Wp
    fc = feat_curr.reshape(*feat_curr.shape[:-3], N, C)
    fn = feat_next.reshape(*feat_next.shape[:-3], N, C)
    d2 = ((fc * fc).sum(-1)[..., :, None] - 2.0 * (fc @ fn.transpose(-1, -2))
          + (fn * fn).sum(-1)[..., None, :])  # (..., N, N)
    bc = box_curr.reshape(*box_curr.shape[:-2], N)
    bn = box_next.reshape(*box_next.shape[:-2], N)
    inside = bc[..., :, None] & bn[..., None, :]
    sim = torch.where(inside, -d2, torch.full_like(d2, -torch.inf))
    best_j = torch.argmax(sim, dim=-1)  # the first maximum, as jnp.argmax
    best_sim = torch.gather(sim, -1, best_j[..., None])[..., 0]
    if lab_curr is not None and lab_next is not None:
        cc = lab_curr.reshape(*lab_curr.shape[:-3], N, 3)
        cn = lab_next.reshape(*lab_next.shape[:-3], N, 3)
        cn = torch.gather(cn.expand(*best_j.shape, 3), -2,
                          best_j[..., None].expand(*best_j.shape, 3))
        col_sim = torch.exp(-torch.sqrt(((cc - cn) ** 2).sum(-1) + 1e-12) * 0.5)
        best_sim = torch.where(col_sim >= color_thresh, best_sim,
                               torch.full_like(best_sim, -torch.inf))
    # the best `num_pairs` source patches, the lower index first among ties
    score, src = torch.sort(best_sim, dim=-1, descending=True, stable=True)
    score, src = score[..., :num_pairs], src[..., :num_pairs]
    dst = torch.gather(best_j, -1, src)
    pairs = torch.stack([src % Wp, src // Wp, dst % Wp, dst // Wp], dim=-1)
    return pairs.to(torch.int32), torch.isfinite(score)


def temporal_pair_log_same(mask_curr: torch.Tensor, mask_next: torch.Tensor,
                           pairs: torch.Tensor) -> torch.Tensor:
    """-log P(same label in both frames) at matched points (reference:
    calculate_temp_similarities :38-70). mask_curr, mask_next (..., h, w)
    logits, pairs (..., Kp, 4) [x_t, y_t, x_t1, y_t1] in mask coordinates,
    with the same leading axes. Returns (..., Kp)."""
    w = mask_curr.shape[-1]
    p = pairs.long()
    pc = torch.gather(mask_curr.flatten(-2), -1, p[..., 1] * w + p[..., 0])
    pn = torch.gather(mask_next.flatten(-2), -1, p[..., 3] * w + p[..., 2])
    same_fg = F.logsigmoid(pc) + F.logsigmoid(pn)
    same_bg = F.logsigmoid(-pc) + F.logsigmoid(-pn)
    mx = torch.maximum(same_fg, same_bg)
    return -(torch.log(torch.exp(same_fg - mx) + torch.exp(same_bg - mx) + 1e-12) + mx)


def temporal_pairwise_loss(src_masks: torch.Tensor, pairs: torch.Tensor,
                           pairs_valid: torch.Tensor, warmup_factor: float = 1.0,
                           valid_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean -log P(same) over the valid matched point pairs (reference:
    sum(sim * 1) / count, :269-334). src_masks (N, T, h, w) matched logits,
    pairs (N, T-1, Kp, 4) in mask coordinates, pairs_valid (N, T-1, Kp).
    `valid_sum`, the count of valid pairs over the batch (at least 1), is
    the criterion's global one; these pairs' count when None."""
    sims = temporal_pair_log_same(src_masks[:, :-1], src_masks[:, 1:], pairs)
    v = pairs_valid.to(sims.dtype)
    if valid_sum is None:
        valid_sum = v.sum().clamp(min=1.0)
    return (sims * v).sum() / valid_sum * warmup_factor


# ---------------------------------------------------------------------------
# The weak video matcher and criterion
# ---------------------------------------------------------------------------


@torch.no_grad()
def video_weaksup_matcher_costs(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                                targets: Mapping[str, torch.Tensor], *, cost_class: float,
                                cost_projection: float, cost_pairwise: float = 0.0,
                                color_thresh: float = 0.3, kernel_size: int = 3,
                                dilation: int = 2, warmup_factor: float = 1.0) -> torch.Tensor:
    """(B, Q, G) costs: the class cost plus the projection cost (and the
    spatial pairwise cost when `cost_pairwise` > 0) of every frame, summed
    over the clip; `PAD_COST` on invalid targets. pred_masks (B, Q, T, h,
    w). Traced as the spans "costs.projection" and "costs.pairwise", a frame
    each."""
    c_class = class_cost(pred_logits, targets["labels"])
    masks = pred_masks.float()
    B, _, T = masks.shape[:3]
    c_mask = []
    for b in range(B):
        c = None
        for t in range(T):
            c = box_mask_costs(
                masks[b, :, t], targets["box_masks"][b, :, t],
                {k: targets[k][b, :, t] for k in BOUNDS}, targets["color_similarity"][b, t], c,
                cost_projection=cost_projection, cost_pairwise=cost_pairwise,
                color_thresh=color_thresh, kernel_size=kernel_size, dilation=dilation,
                warmup_factor=warmup_factor)
        c_mask.append(c)
    return pad_costs(cost_class * c_class + torch.stack(c_mask), targets["valid"])


def video_weaksup_set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cfg: SetCriterionConfig,
    *,
    sup_type: str = "mask_projection_and_spatial_pairwise_and_temporal_pairwise",
    projection_weight: float = 5.0,
    pairwise_weight: float = 5.0,
    temporal_pairwise_weight: float = 5.0,
    color_thresh: float = 0.3,
    kernel_size: int = 3,
    dilation: int = 2,
    warmup_factor: float = 1.0,
    assign_fn: Callable[[torch.Tensor], torch.Tensor] = assign,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The box-supervised video loss over the final and aux layers. targets
    as `target_prep.build_video_weaksup_targets` gives them: labels, valid
    (B, G), box_masks (B, G, T, h, w), bounds (B, G, T, h|w),
    color_similarity (B, T, h, w, K), and, with DINO features,
    temporal_pairs (B, G, T-1, Kp, 4) and temporal_pairs_valid (B, G, T-1,
    Kp). The temporal loss runs when the sup_type names it and the pairs
    are there. Returns (total, {loss_ce, loss_mask_projection[,
    loss_mask_spatial_pairwise][, loss_mask_temporal_pairwise], ...,
    temp_pair_valid_prop}); the JAX function's `rng` is not taken (it
    draws nothing). Traced as `criterion.set_criterion` is."""
    use_spat = "pairwise" in sup_type  # as JAX's: either pairwise loss turns it on
    use_temp = "temporal_pairwise" in sup_type and "temporal_pairs" in targets
    labels, valid = targets["labels"], targets["valid"]
    T, h, w = outputs["pred_masks"].shape[2:]
    pair_kw = dict(kernel_size=kernel_size, dilation=dilation, warmup_factor=warmup_factor)

    def layer_costs(i, logits, masks):
        return video_weaksup_matcher_costs(
            logits, masks, targets, cost_class=cfg.class_weight,
            cost_projection=projection_weight,
            cost_pairwise=pairwise_weight if use_spat else 0.0,
            color_thresh=color_thresh, **pair_kw)

    def step_targets(assignment):
        b_idx, g_idx, box_v, bounds_v, ones_v, pair_w = valid_rows(
            targets, targets["box_masks"], color_thresh, use_spat)
        n = b_idx.shape[0]
        extra = [pair_w.sum()] if use_spat else []
        if use_temp:
            pairs_v = targets["temporal_pairs"][b_idx, g_idx]  # (n, T-1, Kp, 4)
            pv_v = targets["temporal_pairs_valid"][b_idx, g_idx]
            extra.append(pv_v.to(torch.float32).sum())

        def layer_losses(i, masks, asg, num_masks, sums):
            src = masks[b_idx, asg[b_idx, g_idx]].float()  # (n, T, h, w)
            src_ft = src.reshape(n * T, h, w)
            terms = {"loss_mask_projection": projection_loss(src_ft, box_v, bounds_v, ones_v,
                                                             num_masks * T)}
            if use_spat:
                terms["loss_mask_spatial_pairwise"] = weighted_pairwise_loss(
                    src_ft, pair_w, sums[0], num_masks * T, **pair_kw)
            if use_temp:
                terms["loss_mask_temporal_pairwise"] = temporal_pairwise_loss(
                    src, pairs_v, pv_v, warmup_factor, valid_sum=sums[-1])
            return terms

        return StepTargets(layer_losses, n, tuple(extra))

    weights = {"loss_ce": cfg.class_weight, "loss_mask_projection": projection_weight}
    if use_spat:
        weights["loss_mask_spatial_pairwise"] = pairwise_weight
    if use_temp:
        weights["loss_mask_temporal_pairwise"] = temporal_pairwise_weight
    total, losses = deep_supervision(outputs, labels, valid, cfg, assign_fn, layer_costs,
                                     step_targets, weights)
    if use_temp:
        # the share of DINO matches that survive (reference
        # video_maskformer_model.py:361-369 loss_pos_temp_pair_prop): this
        # rank's share of the global batch's mean, which the trainer's sum
        # of the ranks' metrics completes (every rank holds as many pairs)
        losses["temp_pair_valid_prop"] = (targets["temporal_pairs_valid"].float().mean()
                                          / data_size())
    return total, losses
