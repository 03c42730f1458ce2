"""Hungarian matcher costs (reference: matcher.py:479-597
`HungarianMatcher.memory_efficient_forward`), as the JAX package computes
them (bm2f_tpu/matching/matcher.py:30-118):

- targets are padded to a fixed G with a validity mask;
- the class, sigmoid-CE and dice costs are batched einsums over random
  sample points shared by all queries and targets of an image;
- padding targets get the constant `PAD_COST`, so the rectangular LSA gives
  them leftover queries, which the criterion then ignores (`pad_costs`,
  with `class_cost` every matcher's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bm2f_tpu_torch.ops.sampling import point_sample

PAD_COST = 1e6


def class_cost(pred_logits: torch.Tensor, tgt_labels: torch.Tensor) -> torch.Tensor:
    """The (B, Q, G) class cost -P(label) of (B, Q, K+1) logits against (B,
    G) labels (any value where a target is invalid: clamped to a class)."""
    K = pred_logits.shape[-1] - 1
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels = tgt_labels.long().clamp(0, K - 1)
    return -torch.gather(prob[..., :K], 2, labels[:, None, :].expand(-1, prob.shape[1], -1))


def pad_costs(C: torch.Tensor, tgt_valid: torch.Tensor) -> torch.Tensor:
    """The (B, Q, G) costs with `PAD_COST` in the columns of invalid
    targets."""
    return torch.where(tgt_valid[:, None, :], C, torch.full_like(C, PAD_COST))


def point_costs(pred_pts: torch.Tensor, tgt_pts: torch.Tensor):
    """Mean-over-points sigmoid CE and dice costs from POINT-MAJOR inputs:
    (B, N, Q) logits x (B, N, G) binary -> two (B, Q, G) costs (reference:
    matcher.py:104-156 batch_dice_loss / batch_sigmoid_ce_loss)."""
    N = pred_pts.shape[1]
    pos = F.softplus(-pred_pts)  # BCE(x, 1)
    neg = F.softplus(pred_pts)  # BCE(x, 0)
    c_ce = (torch.einsum("bnq,bng->bqg", pos, tgt_pts)
            + torch.einsum("bnq,bng->bqg", neg, 1.0 - tgt_pts)) / N
    p = torch.sigmoid(pred_pts)
    num = 2.0 * torch.einsum("bnq,bng->bqg", p, tgt_pts)
    den = p.sum(1)[:, :, None] + tgt_pts.sum(1)[:, None, :]
    c_dice = 1.0 - (num + 1.0) / (den + 1.0)
    return c_ce, c_dice


@torch.no_grad()
def hungarian_matcher_costs(
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    pred_masks: torch.Tensor,  # (B, Q, h, w) logits
    tgt_labels: torch.Tensor,  # (B, G) int (any value where invalid)
    tgt_nhwc: torch.Tensor,  # (B, Hg, Wg, G) float 0/1
    tgt_valid: torch.Tensor,  # (B, G) bool
    coords: torch.Tensor,  # (B, N, 2) uniform points in [0, 1]
    *,
    cost_class: float = 2.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
) -> torch.Tensor:
    """The (B, Q, G) matching cost matrix. Takes the targets NHWC, as the
    criterion samples them for every layer."""
    c_class = class_cost(pred_logits, tgt_labels)
    pred_pts = point_sample(pred_masks.float().permute(0, 2, 3, 1), coords)
    tgt_pts = point_sample(tgt_nhwc, coords)
    c_mask, c_dice = point_costs(pred_pts, tgt_pts)
    C = cost_class * c_class + cost_mask * c_mask + cost_dice * c_dice
    return pad_costs(C, tgt_valid)
