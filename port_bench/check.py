"""The numbers that decide `correct`, each against its limit.

Training (the first `checked_steps` steps of the window's own trainer
against the reference's, from the same weights, batches and points):
- loss_rel: the widest relative gap of a step's total loss;
- terms_rel: the widest gap of one loss term of one step, over the larger
  of the reference's term and the median term of that step;
- grad_norm_rel: the widest relative gap of a step's gradient norm (before
  clipping);
- grad1_leaf: for each weight, the gap between the norms of its first
  clipped gradient (the program's worked out from its AdamW state after
  one step: mu / (1 - beta1)), over the larger of the reference's norm and
  the median weight's; the widest;
- change_leaf: the same for each weight's change over the checked steps,
  leaving out the weights whose reference gradient is under a thousandth of
  the median weight's (they move by round-off alone; `still_leaves` counts
  them);
- out1_rel: the mask logits of the decoder's first head on the first
  step's batch (the network up to its mask features: the backbone, the
  pixel decoder with its deformable core; before any masked attention,
  update or other discrete choice), image by image: the widest over the
  images of |p - r| / |r| (L2 over the image's values); an image the
  program did not produce reads 1;
- loss1_rel, terms1_rel, grad_norm1_rel: the first step's alone;
- grad1_median, change_median: the median weight's gap instead of the
  widest.
A cell compares the numbers its `cells/<name>.json` gives limits; the rest
are read (by `calibrate`) and not compared.

Serving (sampled requests of the window against the reference on the same
image and weights):
- logits_gap, masks_gap: the widest gap of the network's class logits and
  mask logits, over the reference's largest magnitude;
- semantic_gap: the widest gap of a semantic probability;
- inst_score_gap: the widest gap between the k-th largest instance scores;
- inst_area_gap: the gap of the instance masks' pixel counts by class,
  summed over classes, over the reference's total;
- panoptic_gap: the share of pixels whose class (or void) differs;
- answer_gap: a request's widest of these.
A run's `answer_med` is the median over its checked requests (one of each
shape) of their answer_gap: the decoder's masked attention turns on
sigmoid < 0.5, and a mask logit that f32 rounding tips moves that one
request's answer by up to 0.17 while TF32 moves every request's.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Numbers = Dict[str, float]


def leaf_gaps(p: Mapping[str, float], r: Mapping[str, float],
              keep: Sequence[str] = ()) -> Dict[str, float]:
    """Each name's gap |p - r| over the larger of |r| and the median |r|."""
    names = list(keep) or list(r)
    floor = statistics.median(abs(r[n]) for n in r)
    return {n: abs(p[n] - r[n]) / max(abs(r[n]), floor, 1e-30) for n in names}


def _rel_worst(p, r, keep=()) -> float:
    return max(leaf_gaps(p, r, keep).values())


def moving(ref) -> List[str]:
    """The weights whose first reference gradient is at least a thousandth
    of the median weight's."""
    med = statistics.median(ref.grad1.values())
    return [k for k, v in ref.grad1.items() if v >= 1e-3 * med]


def output_gap(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor]) -> float:
    """out1_rel: image by image, over the outputs `ref` holds."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        for b in range(r.shape[0]):
            if p is None or b >= p.shape[0] or p[b].shape != r[b].shape:
                worst = max(worst, 1.0)
                continue
            d = p[b].float().to(r.device) - r[b]
            worst = max(worst, float(d.norm() / r[b].norm().clamp(min=1e-30)))
    return worst


def train_numbers(prog: Mapping, ref) -> Numbers:
    """prog: {"total": [..], "losses": [{..}], "grad_norm": [..], "grad1":
    {name: norm}, "change": {name: norm}, "out1": {output: tensor}}; ref: a
    reference StepRecord."""
    n = len(ref.total)
    loss_rel = max(abs(prog["total"][t] - ref.total[t]) / abs(ref.total[t]) for t in range(n))
    terms_rel = max(_rel_worst(prog["losses"][t], ref.losses[t]) for t in range(n))
    gn_rel = max(abs(prog["grad_norm"][t] - ref.grad_norm[t]) / ref.grad_norm[t]
                 for t in range(n))
    g1 = leaf_gaps(prog["grad1"], ref.grad1)
    keep = moving(ref)
    ch = leaf_gaps(prog["change"], ref.change, keep)
    return {"loss_rel": loss_rel, "terms_rel": terms_rel, "grad_norm_rel": gn_rel,
            "grad1_leaf": max(g1.values()), "change_leaf": max(ch.values()),
            "out1_rel": output_gap(prog.get("out1", {}), ref.out1),
            "loss1_rel": abs(prog["total"][0] - ref.total[0]) / abs(ref.total[0]),
            "terms1_rel": _rel_worst(prog["losses"][0], ref.losses[0]),
            "grad_norm1_rel": abs(prog["grad_norm"][0] - ref.grad_norm[0]) / ref.grad_norm[0],
            "grad1_median": statistics.median(g1.values()),
            "change_median": statistics.median(ch.values()),
            "still_leaves": float(len(ref.grad1) - len(keep))}


def _panoptic_classes(seg: np.ndarray, segments: List[Dict]) -> np.ndarray:
    lut = np.full(int(seg.max()) + 1 if seg.size else 1, -1, np.int64)
    for s in segments:
        lut[int(s["id"])] = int(s["category_id"])
    return lut[seg]


def _area_by_class(labels: np.ndarray, masks: np.ndarray, K: int) -> np.ndarray:
    return np.bincount(labels.astype(np.int64), weights=masks.reshape(len(labels), -1).sum(1),
                       minlength=K)


def serve_numbers(prog: Mapping, ref: Mapping, num_classes: int) -> Numbers:
    """prog: the program's pred_logits, pred_masks (device) and its host
    outputs (semantic, instances, panoptic) of one request; ref: the
    reference's `serve.infer` of the same image."""
    def gap(a, b):
        b = b.float()
        return float((a.float().to(b.device) - b).abs().max() / b.abs().max().clamp(min=1e-30))

    sem = torch.as_tensor(prog["semantic"]).to(ref["semantic"].device)
    ip, ir = prog["instances"], {k: v.cpu().numpy() for k, v in ref["instances"].items()}
    sp, sr = np.sort(ip["scores"])[::-1], np.sort(ir["scores"])[::-1]
    ap = _area_by_class(ip["labels"], ip["masks"], num_classes)
    ar = _area_by_class(ir["labels"], ir["masks"], num_classes)
    seg_r, segs_r = ref["panoptic"]
    cls_p = _panoptic_classes(*prog["panoptic"])
    cls_r = _panoptic_classes(seg_r.cpu().numpy(), segs_r)
    parts = {"logits_gap": gap(prog["pred_logits"], ref["pred_logits"]),
             "masks_gap": gap(prog["pred_masks"], ref["pred_masks"]),
             "semantic_gap": float((sem - ref["semantic"]).abs().max()),
             "inst_score_gap": float(np.abs(sp - sr).max()),
             "inst_area_gap": float(np.abs(ap - ar).sum() / max(ar.sum(), 1.0)),
             "panoptic_gap": float((cls_p != cls_r).mean())}
    return {"answer_gap": max(parts.values()), **parts}


def worst(readings: Sequence[Numbers]) -> Numbers:
    """Each number's widest reading over several requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def served(readings: Sequence[Numbers]) -> Numbers:
    """A run's served numbers: answer_med, then each part's widest."""
    return {"answer_med": statistics.median(r["answer_gap"] for r in readings),
            **worst(readings)}


def judge(numbers: Numbers, limits: Mapping[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every compared number within its limit, [(name, number, limit)]).
    A number that is not finite fails."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
