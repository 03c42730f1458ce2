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
(`deep_supervision`, the loop every set criterion shares).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from bm2f_tpu_torch.losses.criterion import SetCriterionConfig
from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.losses.weaksup import (
    pairwise_cost_matrix,
    pairwise_weights,
    projection_cost_matrix,
    projection_loss,
    update_box_masks,
    weighted_pairwise_loss,
)
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import class_cost, pad_costs
from bm2f_tpu_torch.utils import tracing

# the projection bounds of a box target (`target_prep`)
BOUNDS = ("left_bounds", "right_bounds", "top_bounds", "bottom_bounds")


def box_mask_costs(masks: torch.Tensor, box_masks: torch.Tensor,
                   bounds: Mapping[str, torch.Tensor], color_similarity: torch.Tensor,
                   acc: Optional[torch.Tensor] = None, *, cost_projection: float,
                   cost_pairwise: float, **pair_kw) -> torch.Tensor:
    """`acc` (when given) plus one image's (Q, G) projection cost, plus its
    pairwise cost (`pair_kw` its keywords) when `cost_pairwise` > 0, each
    added in its turn. masks (Q, h, w) logits, box_masks (G, h, w), bounds
    {BOUNDS: (G, h|w)}, color_similarity (h, w, K). Traced as the spans
    "costs.projection" and "costs.pairwise"."""
    with tracing.span("costs.projection"):
        c = cost_projection * projection_cost_matrix(masks, box_masks, bounds)
        if acc is not None:
            c = acc + c
    if cost_pairwise > 0.0:
        with tracing.span("costs.pairwise"):
            c = c + cost_pairwise * pairwise_cost_matrix(masks, color_similarity, box_masks,
                                                         **pair_kw)
    return c


def valid_rows(targets: Mapping[str, torch.Tensor], box_masks: torch.Tensor,
               color_thresh: float, pairwise: bool):
    """The valid targets' rows (b, g), one host synchronise a step: (b_idx,
    g_idx, box_masks (N, h, w), bounds, ones (N,), the pairwise weights (N,
    h, w, K) or None), a video target's frames a row each."""
    b_idx, g_idx = targets["valid"].nonzero(as_tuple=True)
    box_v = box_masks[b_idx, g_idx].flatten(0, -3)
    bounds_v = {k: targets[k][b_idx, g_idx].flatten(0, -2) for k in BOUNDS}
    ones_v = torch.ones(box_v.shape[0], device=box_v.device)
    pair_w = None
    if pairwise:  # the same edges in every layer
        pair_w = pairwise_weights(targets["color_similarity"][b_idx].flatten(0, -4), box_v,
                                  ones_v, color_thresh, torch.float32)
    return b_idx, g_idx, box_v, bounds_v, ones_v, pair_w


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
    c_class = class_cost(pred_logits, targets["labels"])
    masks = pred_masks.float()
    c_mask = [box_mask_costs(
        masks[b], targets["box_masks"][b], {k: targets[k][b] for k in BOUNDS},
        targets["color_similarity"][b], cost_projection=cost_projection,
        cost_pairwise=cost_pairwise, color_thresh=color_thresh, kernel_size=kernel_size,
        dilation=dilation, warmup_factor=warmup_factor) for b in range(masks.shape[0])]
    return pad_costs(cost_class * c_class + torch.stack(c_mask), targets["valid"])


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
    pair_kw = dict(kernel_size=kernel_size, dilation=dilation, warmup_factor=warmup_factor)

    def layer_costs(i, logits, masks):
        return weaksup_matcher_costs(
            logits, masks, targets, cost_class=cfg.class_weight,
            cost_projection=projection_weight,
            cost_pairwise=pairwise_weight if use_pairwise else 0.0,
            color_thresh=color_thresh, **pair_kw)

    def step_targets(assignment):
        box_masks = targets["box_masks"]
        if mask_update_pix_thr is not None:
            box_masks = update_box_masks(outputs["pred_masks"].detach().float(),
                                         assignment[:, -1], box_masks, mask_update_pix_thr)
        b_idx, g_idx, box_v, bounds_v, ones_v, pair_w = valid_rows(targets, box_masks,
                                                                   color_thresh, use_pairwise)

        def layer_losses(i, masks, asg, num_masks, sums):
            src = masks[b_idx, asg[b_idx, g_idx]].float()  # (N, h, w)
            terms = {"loss_mask_projection": projection_loss(src, box_v, bounds_v, ones_v,
                                                             num_masks)}
            if use_pairwise:
                terms["loss_pairwise"] = weighted_pairwise_loss(src, pair_w, sums[0],
                                                                num_masks, **pair_kw)
            return terms

        return StepTargets(layer_losses, b_idx.shape[0],
                           (pair_w.sum(),) if use_pairwise else ())

    weights = {"loss_ce": cfg.class_weight, "loss_mask_projection": projection_weight}
    if use_pairwise:
        weights["loss_pairwise"] = pairwise_weight
    return deep_supervision(outputs, labels, valid, cfg, assign_fn, layer_costs, step_targets,
                            weights)
