"""The deep-supervision loop of the four set criteria (reference:
mask2former/modeling/criterion.py:925-958, `SetCriterion.forward`'s
aux_outputs loop). A criterion brings a layer's matching costs, its
targets-side work of the step and a layer's terms; the loop runs every
layer, the aux layers first and the final layer last (so aux terms are
named `name_0` .. `name_{L-1}`, as in the reference): the costs of all
layers under the span "train.matcher_costs", ONE `assign_fn` call on them
under "train.assign", and under "train.losses" the criterion's work of the
step, the counters "targets.slots", "targets.valid" and (where the
criterion point-samples its targets) "targets.point_slots", the
denominators, the class CE (`loss_labels`) and the criterion's terms of
every layer, and the weighted total.

The batch is the GLOBAL batch, as in the JAX package's one SPMD step: under
data parallelism each rank holds its rows of it, and every batch-wide
denominator (`num_masks`, the class CE's weight sum of each layer, and a
criterion's own sums) is the sum over the data group (every rank, or one
rank of each model group under tensor parallelism), taken in one
all-reduce of a small vector a step (`label_denominators`). Each rank's
losses are its own numerators over those denominators, so the ranks'
losses and gradients sum to the global ones (the trainer sums the
gradients; it does not average them). Upstream Mask2Former all-reduces
`num_masks` alone and averages the rest, which is another loss whenever
the ranks hold different numbers of targets or matches.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from bm2f_tpu_torch.parallel import global_sum
from bm2f_tpu_torch.utils import tracing


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


def loss_labels(pred_logits, target_classes, w, w_sum):
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


class StepTargets(NamedTuple):
    """A criterion's work of one step: `layer_losses(i, masks, assignment,
    num_masks, sums)` -> layer i's terms but its class CE, given the global
    values (at least 1) of the local `sums`; the valid targets' count
    `n_valid`, read on the host; the target slots its point losses take,
    `point_slots`, where it point-samples them."""
    layer_losses: Callable[..., Dict[str, torch.Tensor]]
    n_valid: int
    sums: Tuple[torch.Tensor, ...] = ()
    point_slots: Optional[int] = None


def deep_supervision(
    outputs: Mapping[str, torch.Tensor],
    labels: torch.Tensor,
    valid: torch.Tensor,
    cfg,
    assign_fn: Callable[[torch.Tensor], torch.Tensor],
    layer_costs: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor],
    step_targets: Callable[[torch.Tensor], StepTargets],
    weights: Mapping[str, float],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A criterion over `outputs`' final and aux layers (see the module's
    docstring), the targets' (B, G) `labels` and `valid`. `layer_costs(i,
    logits, masks)` is layer i's (B, Q, G) costs; `assign_fn` maps the (B,
    L+1, Q, G) costs to the (B, L+1, G) assignment; `weights` {name:
    weight}, "loss_ce" first, in a layer's order of terms. Returns (total,
    {name_0: aux layer 0's term, ..., name: the final layer's})."""
    layers = [(outputs["aux_logits"][i], outputs["aux_masks"][i])
              for i in range(outputs["aux_logits"].shape[0])]
    layers.append((outputs["pred_logits"], outputs["pred_masks"]))

    with tracing.span("train.matcher_costs"):
        costs = torch.stack([layer_costs(i, logits, masks)
                             for i, (logits, masks) in enumerate(layers)], 1)
    with tracing.span("train.assign"):
        assignment = assign_fn(costs)  # (B, L+1, G)

    with tracing.span("train.losses"):
        step = step_targets(assignment)
        tracing.count("targets.slots", valid.numel())
        tracing.count("targets.valid", step.n_valid)
        if step.point_slots is not None:
            tracing.count("targets.point_slots", step.point_slots)
        num_masks, ce, sums = label_denominators(layers, labels, valid, assignment, cfg,
                                                 *step.sums)
        losses: Dict[str, torch.Tensor] = {}
        terms = {name: [] for name in weights}
        for i, (logits, masks) in enumerate(layers):
            suffix = "" if i == len(layers) - 1 else f"_{i}"
            layer = {"loss_ce": loss_labels(logits, *ce[i]),
                     **step.layer_losses(i, masks, assignment[:, i], num_masks, sums)}
            for name, term in layer.items():
                terms[name].append(term)
                losses[name + suffix] = term
        total = None
        for name, weight in weights.items():
            weighted = weight * torch.stack(terms[name]).sum()
            total = weighted if total is None else total + weighted
    return total, losses
