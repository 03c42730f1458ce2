"""SetCriterion: Hungarian-matched classification and point-sampled mask
losses with deep supervision (reference: mask2former/modeling/criterion.py:
775-958), as the JAX package computes them (bm2f_tpu/losses/criterion.py):

- targets are fixed-shape (G-padded, with a validity mask);
- the matchings of the final layer and of every aux layer are solved in ONE
  host step (one device-to-host copy of all costs);
- candidate and random points are shared across the masks of an image, and
  the importance-selected points enter the loss as a 0/1 weight over the
  candidates: a threshold plus an index-order tie rank selects exactly the
  set `jax.lax.top_k` selects (lower index first among equal values);
- `num_masks` is the sum of valid targets over the batch.

The batch is the GLOBAL batch, as in the JAX package's one SPMD step: under
data parallelism each rank holds its rows of it, and every batch-wide
denominator (`num_masks`, the class CE's weight sum of each layer) is the
sum over the data group (every rank, or one rank of each model group under
tensor parallelism), taken in one all-reduce of a small vector a step
(`label_denominators`). Each rank's losses are its own numerators over
those denominators, so the ranks' losses and gradients sum to the global
ones (the trainer sums the gradients; it does not average them). Upstream
Mask2Former all-reduces `num_masks` alone and averages the rest, which is
another loss whenever the ranks hold different numbers of targets or
matches.

Every random point comes in through `points` (see `draw_points`), so that a
run is reproducible from a `torch.Generator` and the tests can hand the
criterion the JAX package's own draws. The assignment comes from
`assign_fn`, as in the JAX `set_criterion(..., assign_fn=)`: the exact host
solve by default, or what `matching.hungarian.make_assign_fn` picks from
`train.matcher`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import hungarian_matcher_costs
from bm2f_tpu_torch.ops.sampling import point_sample
from bm2f_tpu_torch.parallel import data_size, global_sum, local_rows
from bm2f_tpu_torch.utils import tracing


@dataclass(frozen=True)
class SetCriterionConfig:
    num_classes: int
    eos_coef: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75

    @property
    def n_importance(self) -> int:
        return int(self.importance_sample_ratio * self.num_points)

    @property
    def n_candidates(self) -> int:
        return int(self.num_points * self.oversample_ratio)


def count_targets(valid: torch.Tensor, n_valid=None) -> None:
    """The tracing counters of a criterion's targets: "targets.slots", the
    (B, G) slots of `valid`, and "targets.valid", the valid ones (`n_valid`
    where the caller has it on the host, else a device sum, taken only while
    tracing is on)."""
    tracing.count("targets.slots", valid.numel())
    if tracing.enabled():
        tracing.count("targets.valid", valid.sum() if n_valid is None else n_valid)


def draw_points(cfg: SetCriterionConfig, n_layers: int, batch: int,
                generator: torch.Generator, frames: int = 1) -> Dict[str, torch.Tensor]:
    """Uniform [0, 1) (x, y) points on the generator's device, per layer and
    image: "match" (L, B, num_points, 2) for the matcher costs, "cand"
    (L, B * frames, n_candidates, 2) and "rand" (L, B * frames, num_points -
    n_importance, 2) for the mask losses. A clip's matcher points are shared
    by its frames; its loss points are drawn per frame (`frames` = T, as the
    video criterion takes them).

    `batch` is this rank's: the points of the whole global batch (`batch` x
    `data_size()` images) are drawn, as the JAX step draws them from one
    key, and this rank keeps its rows (`local_rows`, by data rank). So the
    ranks' generators stay in step, and one rank's state is every rank's."""
    dev = generator.device
    n_rand = cfg.num_points - cfg.n_importance
    glob = batch * data_size()
    return {
        name: local_rows(torch.rand((n_layers, b, n, 2), generator=generator, device=dev),
                         axis=1)
        for name, b, n in (("match", glob, cfg.num_points),
                           ("cand", glob * frames, cfg.n_candidates),
                           ("rand", glob * frames, n_rand))
    }


def class_targets(tgt_labels, tgt_valid, assignment, num_queries: int, cfg):
    """The (B, Q) class target of every query (`num_classes`, "no object",
    for a query no valid target is assigned to) and its CE weight
    (`eos_coef` for "no object", else 1). Padding targets scatter into an
    extra column Q, which is cut."""
    B, Q, K = assignment.shape[0], num_queries, cfg.num_classes
    target_classes = torch.full((B, Q + 1), K, dtype=torch.long, device=assignment.device)
    scatter_q = torch.where(tgt_valid, assignment, torch.full_like(assignment, Q))
    target_classes.scatter_(1, scatter_q, tgt_labels.long())
    target_classes = target_classes[:, :Q]
    return target_classes, torch.where(target_classes == K, cfg.eos_coef, 1.0)


def _loss_labels(pred_logits, target_classes, w, w_sum):
    """Weighted CE over all queries; unmatched queries learn 'no object'
    (reference: criterion.py:809-826). `target_classes` and `w` as
    `class_targets` gives them; `w_sum` is the batch's sum of `w` (at least
    1, `label_denominators`)."""
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = -logp.gather(-1, target_classes[..., None])[..., 0]
    return (w * nll).sum() / w_sum


def label_denominators(layers, tgt_labels, tgt_valid, assignment, cfg, *extra_sums):
    """`class_targets` of every layer and the batch's denominators:
    (num_masks, [(target_classes, w, w_sum) per layer], [the `extra_sums`
    (0-d) over the batch]). `assignment` (B, L+1, G). Each denominator is
    the local sum summed over the ranks, all in ONE all-reduce of a small
    vector (`num_masks` first), then at least 1: the JAX package's
    `jnp.maximum(sum, 1.0)` over the global batch."""
    Q = layers[0][0].shape[1]
    cls = [class_targets(tgt_labels, tgt_valid, assignment[:, i], Q, cfg)
           for i in range(len(layers))]
    local = [tgt_valid.float().sum(), *(w.sum() for _, w in cls), *extra_sums]
    num_masks, *sums = (d.clamp(min=1.0).to(t.dtype)
                        for d, t in zip(global_sum(torch.stack(local)).unbind(0), local))
    labels = [(tc, w, s) for (tc, w), s in zip(cls, sums)]
    return num_masks, labels, sums[len(cls):]


def _masked_sums(logits, labels, w):
    """sum over (weighted) points of CE, p, p*t and t -> (B, G) each."""
    ce = logits.clamp(min=0) - logits * labels + F.softplus(-logits.abs())
    p = torch.sigmoid(logits)
    return ((ce * w).sum(1), (p * w).sum(1), (p * labels * w).sum(1),
            (labels * w).sum(1))


def _importance_weights(pred_c: torch.Tensor, n_imp: int) -> torch.Tensor:
    """(B, n_cand, G) candidate logits -> 0/1 weights selecting, per mask,
    the n_imp most uncertain candidates (smallest |logit|): the ones
    strictly above the k-th value, then the first ties in index order."""
    B, n_cand, G = pred_c.shape
    u = -pred_c.detach().abs().transpose(1, 2).reshape(B * G, n_cand)
    kth = torch.topk(u, n_imp, dim=-1).values[:, -1:]
    above = u > kth
    eq = u == kth
    need = n_imp - above.sum(-1, keepdim=True)
    tie_rank = torch.cumsum(eq.to(torch.int64), dim=-1)  # inclusive
    w_sel = (above | (eq & (tie_rank <= need))).to(pred_c.dtype)
    return w_sel.reshape(B, G, n_cand).transpose(1, 2)


def _loss_masks(pred_masks, tgt_nhwc, tgt_valid, assignment, num_masks, cfg,
                cand, randc):
    """Point-sampled sigmoid CE + dice on the matched masks (reference:
    criterion.py:827-883). tgt_nhwc (B, Hg, Wg, G); cand (B, n_cand, 2) and
    randc (B, n_rand, 2) points."""
    B, Q, h, w = pred_masks.shape
    G = tgt_valid.shape[1]
    src = torch.gather(pred_masks, 1,
                       assignment[:, :, None, None].expand(B, G, h, w)).float()
    return point_mask_losses(src.permute(0, 2, 3, 1), tgt_nhwc,
                             tgt_valid.reshape(B * G).float(), num_masks, cfg, cand, randc)


def point_mask_losses(src_nhwc, tgt_nhwc, valid, num_masks, cfg, cand, randc):
    """The sigmoid CE and dice losses of the matched mask logits `src_nhwc`
    (N, h, w, G) against the targets `tgt_nhwc` (N, Hg, Wg, G), on the
    candidate points `cand` (N, n_cand, 2) (the most uncertain
    `cfg.n_importance` of them) and the random points `randc` (N, n_rand,
    2) of each of the N images; `valid` (N * G,) weights each mask; each
    loss is summed over the masks and divided by `num_masks`."""
    pred_c = point_sample(src_nhwc, cand)  # (N, n_cand, G)
    with torch.no_grad():
        tgt_c = point_sample(tgt_nhwc, cand)
    w_sel = _importance_weights(pred_c, cfg.n_importance)
    ce_s, p_s, pt_s, t_s = _masked_sums(pred_c, tgt_c, w_sel)
    if randc.shape[1] > 0:
        pred_r = point_sample(src_nhwc, randc)
        with torch.no_grad():
            tgt_r = point_sample(tgt_nhwc, randc)
        ce_r, p_r, pt_r, t_r = _masked_sums(pred_r, tgt_r, 1.0)
        ce_s, p_s, pt_s, t_s = ce_s + ce_r, p_s + p_r, pt_s + pt_r, t_s + t_r

    ce_per_mask = (ce_s / cfg.num_points).reshape(-1) * valid
    dice_per_mask = (1.0 - (2.0 * pt_s + 1.0) / (p_s + t_s + 1.0)).reshape(-1) * valid
    return ce_per_mask.sum() / num_masks, dice_per_mask.sum() / num_masks


def set_criterion(
    outputs: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    cfg: SetCriterionConfig,
    points: Mapping[str, torch.Tensor],
    assign_fn: Callable[[torch.Tensor], torch.Tensor] = assign,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: pred_logits (B, Q, K+1), pred_masks (B, Q, h, w), aux_logits
    (L, B, Q, K+1), aux_masks (L, B, Q, h, w). targets: labels (B, G) int,
    masks (B, G, Hg, Wg) 0/1, valid (B, G) bool. points: `draw_points` for
    L+1 layers, aux layers first. `assign_fn` maps the (B, L+1, Q, G) costs
    to the (B, L+1, G) assignment. Traced (`utils.tracing`) as the spans
    "train.matcher_costs", "train.assign" and "train.losses" and the
    counters "targets.valid" and "targets.slots" (`count_targets`).
    Returns (total_loss, {loss_ce, loss_mask, loss_dice, loss_ce_0, ...})."""
    tgt_labels, tgt_valid = targets["labels"], targets["valid"]
    n_aux = outputs["aux_logits"].shape[0]
    # all layers, final LAST (so aux losses are indexed 0..L-1 as reference)
    layers = [(outputs["aux_logits"][i], outputs["aux_masks"][i]) for i in range(n_aux)]
    layers.append((outputs["pred_logits"], outputs["pred_masks"]))
    tgt_nhwc = targets["masks"].float().permute(0, 2, 3, 1).contiguous()
    count_targets(tgt_valid)

    with tracing.span("train.matcher_costs"):
        costs = torch.stack([
            hungarian_matcher_costs(
                logits, masks, tgt_labels, tgt_nhwc, tgt_valid, points["match"][i],
                cost_class=cfg.class_weight, cost_mask=cfg.mask_weight,
                cost_dice=cfg.dice_weight)
            for i, (logits, masks) in enumerate(layers)
        ], 1)  # (B, L+1, Q, G)
    with tracing.span("train.assign"):
        assignment = assign_fn(costs)  # (B, L+1, G)

    with tracing.span("train.losses"):
        num_masks, labels, _ = label_denominators(layers, tgt_labels, tgt_valid, assignment,
                                                  cfg)
        losses: Dict[str, torch.Tensor] = {}
        ce_l, mask_l, dice_l = [], [], []
        for i, (logits, masks) in enumerate(layers):
            ce_l.append(_loss_labels(logits, *labels[i]))
            loss_mask, loss_dice = _loss_masks(
                masks, tgt_nhwc, tgt_valid, assignment[:, i], num_masks, cfg,
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
