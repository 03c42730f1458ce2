"""The weak-supervision criterion: projection and pairwise losses with
Hungarian matching over the final and aux layers (bm2f_tpu/losses/
weaksup_criterion.py; reference: SetCriterionProj criterion.py:445,
SetCriterionProjPair :184; matchers HungarianMatcherProj matcher.py:356,
HungarianMatcherProjPair :219; selected by MODEL.MASK_FORMER.SUP_TYPE,
maskformer_model.py:126-225).

Targets, as `target_prep.build_weaksup_targets` gives them, at the stride of
the predicted masks: labels (B, G) int, valid (B, G) bool, box_masks (B, G,
h, w), left/right_bounds (B, G, h), top/bottom_bounds (B, G, w),
color_similarity (B, h, w, K).

The losses are computed on the valid targets' rows only. The JAX package
computes them on all B x G rows and multiplies the invalid ones by 0, so
the numbers are the same up to summation order, and autograd keeps no
(B x G, h, w, K) tensors of padding: at the 864x1408 canvas with G = 100
those would be ~0.5 GB each, about eight a layer.

`num_masks`, the class CE's weight sums and the pairwise loss's weight sum
are the global batch's, in one all-reduce a step under data parallelism
(`criterion.label_denominators`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from bm2f_tpu_torch.losses.criterion import (
    SetCriterionConfig,
    _loss_labels,
    count_targets,
    label_denominators,
)
from bm2f_tpu_torch.losses.weaksup import (
    pairwise_cost_matrix,
    pairwise_weights,
    projection_cost_matrix,
    projection_loss,
    update_box_masks,
    weighted_pairwise_loss,
)
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import PAD_COST
from bm2f_tpu_torch.utils import tracing

_BOUNDS = ("left_bounds", "right_bounds", "top_bounds", "bottom_bounds")


@torch.no_grad()
def weaksup_matcher_costs(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                          targets: Mapping[str, torch.Tensor], *, cost_class: float,
                          cost_projection: float, cost_pairwise: float = 0.0,
                          color_thresh: float = 0.3, kernel_size: int = 3,
                          dilation: int = 2, warmup_factor: float = 1.0) -> torch.Tensor:
    """(B, Q, G) costs: the class cost plus the projection cost, plus the
    pairwise cost when `cost_pairwise` > 0; `PAD_COST` on invalid targets.
    pred_logits (B, Q, K+1), pred_masks (B, Q, h, w). Traced as the spans
    "costs.projection" and "costs.pairwise", an image each."""
    B, Q = pred_logits.shape[:2]
    K = pred_logits.shape[-1] - 1
    labels, valid = targets["labels"], targets["valid"]
    G = labels.shape[1]
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels_safe = labels.long().clamp(0, K - 1)
    c_class = -prob[..., :K].gather(2, labels_safe[:, None, :].expand(B, Q, G))

    masks = pred_masks.float()
    c_mask = []
    for b in range(B):
        bounds = {k: targets[k][b] for k in _BOUNDS}
        with tracing.span("costs.projection"):
            c = cost_projection * projection_cost_matrix(masks[b], targets["box_masks"][b],
                                                         bounds)
        if cost_pairwise > 0.0:
            cs = targets["color_similarity"][b]
            with tracing.span("costs.pairwise"):
                c = c + cost_pairwise * pairwise_cost_matrix(
                    masks[b], cs[None].expand(G, *cs.shape), targets["box_masks"][b],
                    color_thresh=color_thresh, kernel_size=kernel_size, dilation=dilation,
                    warmup_factor=warmup_factor)
        c_mask.append(c)
    C = cost_class * c_class + torch.stack(c_mask)
    return torch.where(valid[:, None, :], C, torch.full_like(C, PAD_COST))


def weaksup_set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cfg: SetCriterionConfig,
    *,
    sup_type: str = "mask_projection_and_pairwise",
    projection_weight: float = 5.0,
    pairwise_weight: float = 5.0,
    color_thresh: float = 0.3,
    kernel_size: int = 3,
    dilation: int = 2,
    warmup_factor: float = 1.0,
    assign_fn: Callable[[torch.Tensor], torch.Tensor] = assign,
    mask_update_pix_thr: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weak-supervision loss over the final and aux layers. Returns
    (total, {loss_ce, loss_mask_projection[, loss_pairwise], loss_ce_0,
    ...}). The JAX function's `rng` is not taken: it draws nothing.

    The costs of every layer (aux layers first, the final layer last) are
    computed without gradient and solved in one `assign_fn` call on (B, L+1,
    Q, G). `mask_update_pix_thr`, when given, intersects the box masks with
    the final layer's confident pixels under its assignment (reference:
    criterion.py:625-676 update_targets) before the losses. Traced as
    `criterion.set_criterion` is."""
    use_pairwise = "pairwise" in sup_type
    labels, valid = targets["labels"], targets["valid"]
    B, G = labels.shape
    layers = [(outputs["aux_logits"][i], outputs["aux_masks"][i])
              for i in range(outputs["aux_logits"].shape[0])]
    layers.append((outputs["pred_logits"], outputs["pred_masks"]))

    with tracing.span("train.matcher_costs"):
        costs = torch.stack([
            weaksup_matcher_costs(
                logits, masks, targets, cost_class=cfg.class_weight,
                cost_projection=projection_weight,
                cost_pairwise=pairwise_weight if use_pairwise else 0.0,
                color_thresh=color_thresh, kernel_size=kernel_size, dilation=dilation,
                warmup_factor=warmup_factor)
            for logits, masks in layers], 1)  # (B, L+1, Q, G)
    with tracing.span("train.assign"):
        assignment = assign_fn(costs)  # (B, L+1, G)

    with tracing.span("train.losses"):
        box_masks = targets["box_masks"]
        if mask_update_pix_thr is not None:
            box_masks = update_box_masks(outputs["pred_masks"].detach().float(),
                                         assignment[:, -1], box_masks, mask_update_pix_thr)
        # the valid targets' rows (b, g), one host synchronise a step
        b_idx, g_idx = valid.nonzero(as_tuple=True)
        count_targets(valid, b_idx.shape[0])
        box_v = box_masks[b_idx, g_idx]  # (N, h, w)
        bounds_v = {k: targets[k][b_idx, g_idx] for k in _BOUNDS}
        ones_v = torch.ones(b_idx.shape[0], device=valid.device)
        pair_sums = ()
        if use_pairwise:
            # the same edges in every layer: (N, h, w, K)
            pair_w = pairwise_weights(targets["color_similarity"][b_idx], box_v, ones_v,
                                      color_thresh, torch.float32)
            pair_sums = (pair_w.sum(),)
        num_masks, ce_labels, pair_sums = label_denominators(layers, labels, valid, assignment,
                                                             cfg, *pair_sums)

        losses: Dict[str, torch.Tensor] = {}
        ce_l, proj_l, pair_l = [], [], []
        for i, (logits, masks) in enumerate(layers):
            asg = assignment[:, i]
            ce_l.append(_loss_labels(logits, *ce_labels[i]))
            src = masks[b_idx, asg[b_idx, g_idx]].float()  # (N, h, w)
            proj_l.append(projection_loss(src, box_v, bounds_v, ones_v, num_masks))
            suffix = "" if i == len(layers) - 1 else f"_{i}"
            losses[f"loss_ce{suffix}"] = ce_l[-1]
            losses[f"loss_mask_projection{suffix}"] = proj_l[-1]
            if use_pairwise:
                pair_l.append(weighted_pairwise_loss(
                    src, pair_w, pair_sums[0], num_masks, kernel_size=kernel_size,
                    dilation=dilation, warmup_factor=warmup_factor))
                losses[f"loss_pairwise{suffix}"] = pair_l[-1]
        total = cfg.class_weight * torch.stack(ce_l).sum() + projection_weight * torch.stack(
            proj_l).sum()
        if use_pairwise:
            total = total + pairwise_weight * torch.stack(pair_l).sum()
    return total, losses
