"""SetCriterion: Hungarian-matched classification and point-sampled mask
losses with deep supervision (reference: mask2former/modeling/criterion.py:
775-958), as the JAX package computes them (bm2f_tpu/losses/criterion.py):

- targets are fixed-shape (G-padded, with a validity mask);
- the matchings of the final layer and of every aux layer are solved in ONE
  host step, and `num_masks` and the class CE's weight sums are the global
  batch's (`deep_supervision`, the loop every set criterion shares);
- candidate and random points are shared across the masks of an image, and
  the importance-selected points enter the loss as a 0/1 weight over the
  candidates: a threshold plus an index-order tie rank selects exactly the
  set `jax.lax.top_k` selects (lower index first among equal values);
- the mask losses are taken over the occupied slots only, the first G' of
  the G (`occupied_slots`): the JAX package computes every slot and
  multiplies the padding by 0, so the numbers are the same up to summation
  order, and no (B, G, h, w) matched masks of padding, their point samples
  or their backward are made. The matched masks are chosen by (layer,
  image, query) row (`matched_masks`), so that their backward is a
  deterministic `index_put_` of rows, not the coordinate sort of a
  scattered `torch.gather`;
- the mask losses of all layers are computed at once, once a step
  (`point_mask_losses` over the layers' stacked matched masks): the same
  numbers as a layer at a time, in a tenth of the launches.

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

from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import hungarian_matcher_costs
from bm2f_tpu_torch.ops.sampling import point_sample
from bm2f_tpu_torch.parallel import data_size, local_rows


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

    @property
    def loss_weights(self) -> Dict[str, float]:
        """The mask criteria's weight of each term, in the terms' order."""
        return {"loss_ce": self.class_weight, "loss_mask": self.mask_weight,
                "loss_dice": self.dice_weight}


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


def occupied_slots(valid: torch.Tensor) -> Tuple[int, int]:
    """(the valid targets' count, G' = 1 + the highest slot that holds a
    valid target in any image, 0 where none does) of the (B, G) `valid`, in
    one host read. Slots from G' on are padding in every image."""
    slot = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    n_valid, occupied = torch.stack([valid.sum(), (valid.any(0) * slot).max()]).tolist()
    return n_valid, occupied


def matched_masks(outputs: Mapping[str, torch.Tensor], assignment: torch.Tensor) -> torch.Tensor:
    """The matched mask logits of every layer, aux layers first: (L+1, B,
    G', ...) from `outputs`' aux_masks (L, B, Q, ...) and pred_masks (B, Q,
    ...) under the (B, L+1, G') `assignment`, chosen by (layer, image,
    query) row."""
    aux, final = outputs["aux_masks"], outputs["pred_masks"]
    L, B = aux.shape[:2]
    rows = torch.arange(B, device=final.device)[:, None]
    layers = torch.arange(L, device=final.device)[:, None, None]
    return torch.cat([aux[layers, rows, assignment[:, :L].transpose(0, 1)],
                      final[rows, assignment[:, L]][None]])


def point_mask_losses(src_nhwc, tgt_nhwc, valid, cfg, cand, randc):
    """The sigmoid CE and dice losses of L layers' matched mask logits
    `src_nhwc` (L, N, h, w, G) against the targets `tgt_nhwc` (N, Hg, Wg,
    G), on each layer's candidate points `cand` (L, N, n_cand, 2) (the most
    uncertain `cfg.n_importance` of them) and random points `randc` (L, N,
    n_rand, 2) of each of the N images; `valid` (N * G,) weights each mask.
    Returns {loss_mask, loss_dice}, each (L,): a layer's loss summed over
    its masks, not yet divided by `num_masks`."""
    L, N = src_nhwc.shape[:2]
    src = src_nhwc.reshape(L * N, *src_nhwc.shape[2:])

    def sample(coords):
        """(the layers' samples (L*N, n, G), the targets' samples there)"""
        n = coords.shape[2]
        pred = point_sample(src, coords.reshape(L * N, n, 2))
        with torch.no_grad():  # the targets once at every layer's points
            tgt = point_sample(tgt_nhwc, coords.transpose(0, 1).reshape(N, L * n, 2))
            tgt = tgt.reshape(N, L, n, -1).transpose(0, 1).reshape(L * N, n, -1)
        return pred, tgt

    pred_c, tgt_c = sample(cand)
    w_sel = _importance_weights(pred_c, cfg.n_importance)
    ce_s, p_s, pt_s, t_s = _masked_sums(pred_c, tgt_c, w_sel)
    if randc.shape[2] > 0:
        ce_r, p_r, pt_r, t_r = _masked_sums(*sample(randc), 1.0)
        ce_s, p_s, pt_s, t_s = ce_s + ce_r, p_s + p_r, pt_s + pt_r, t_s + t_r

    ce_per_mask = (ce_s / cfg.num_points).reshape(L, -1) * valid
    dice_per_mask = (1.0 - (2.0 * pt_s + 1.0) / (p_s + t_s + 1.0)).reshape(L, -1) * valid
    return {"loss_mask": ce_per_mask.sum(1), "loss_dice": dice_per_mask.sum(1)}


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
    counters "targets.valid", "targets.slots" and "targets.point_slots"
    (`deep_supervision`).
    Returns (total_loss, {loss_ce, loss_mask, loss_dice, loss_ce_0, ...})."""
    tgt_labels, tgt_valid = targets["labels"], targets["valid"]
    tgt_nhwc = targets["masks"].float().permute(0, 2, 3, 1).contiguous()

    def layer_costs(i, logits, masks):
        return hungarian_matcher_costs(
            logits, masks, tgt_labels, tgt_nhwc, tgt_valid, points["match"][i],
            cost_class=cfg.class_weight, cost_mask=cfg.mask_weight, cost_dice=cfg.dice_weight)

    def step_targets(assignment):
        nonlocal tgt_nhwc
        n_valid, occupied = occupied_slots(tgt_valid)
        tgt_loss = tgt_nhwc[..., :occupied].contiguous()  # (B, Hg, Wg, G')
        tgt_nhwc = None  # the matching is done: free the all-slot copy
        B = tgt_valid.shape[0]
        valid = tgt_valid[:, :occupied].reshape(B * occupied).float()
        # point-sampled sigmoid CE + dice on the matched masks of the
        # occupied slots, every layer's at once (reference: criterion.py:827-883)
        src = matched_masks(outputs, assignment[:, :, :occupied]).float()  # (L+1, B, G', h, w)
        sums = point_mask_losses(src.permute(0, 1, 3, 4, 2), tgt_loss, valid, cfg,
                                 points["cand"], points["rand"])

        def layer_losses(i, masks, asg, num_masks, _):
            return {name: s[i] / num_masks for name, s in sums.items()}

        return StepTargets(layer_losses, n_valid, point_slots=B * occupied)

    return deep_supervision(outputs, tgt_labels, tgt_valid, cfg, assign_fn, layer_costs,
                            step_targets, cfg.loss_weights)
