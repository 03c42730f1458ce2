"""The reference's first training steps: forward, criterion, gradient and
AdamW, from the benchmark's weights, on the benchmark's batches and points.

`train_steps` returns what the benchmark compares: each step's total and
losses and gradient norm, every trainable weight's norm of its first
clipped gradient (what the optimizer gets), and of its change over the
steps, and the first head's mask logits on the first step's batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from port_bench.reference.criterion import LossWeights, mask_criterion
from port_bench.reference.model import Arch, forward
from port_bench.reference.numerics import Numerics
from port_bench.reference.optim import AdamW, AdamWConfig, trainable
from port_bench.reference.weak import weak_criterion



@dataclass(frozen=True)
class WeakConfig:
    projection_weight: float = 5.0
    pairwise_weight: float = 5.0
    color_thresh: float = 0.3
    warmup_iters: int = 10000
    mask_update: bool = False
    mask_update_steps: Sequence[float] = (0.0, 0.5, 1.0)
    mask_update_thrs: Sequence[float] = (0.0, 0.5)
    max_iter: int = 180000


@dataclass
class StepRecord:
    total: List[float] = field(default_factory=list)
    losses: List[Dict[str, float]] = field(default_factory=list)
    grad_norm: List[float] = field(default_factory=list)
    grad1: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    out1: Dict[str, torch.Tensor] = field(default_factory=dict)


def first_head_masks(out) -> torch.Tensor:
    """The mask logits of the decoder's first head, (B, Q, H/4, W/4): the
    network up to its mask features, before any masked attention."""
    return out["aux_masks"][0]


def warmup_factor(t: int, iters: int) -> float:
    return float(min(np.float32(t) / np.float32(max(iters, 1)), np.float32(1.0)))


def pix_thr(t: int, wc: WeakConfig) -> float:
    frac = np.float32(t) / np.float32(max(wc.max_iter, 1))
    thr = wc.mask_update_thrs[0]
    for i in range(1, len(wc.mask_update_thrs)):
        if frac >= np.float32(wc.mask_update_steps[i]):
            thr = wc.mask_update_thrs[i]
    return float(thr)


def loss_of(P, batch, points, t, arch: Arch, lw: LossWeights, weak: Optional[WeakConfig]):
    """(total, losses, the network's outputs) of one step's batch."""
    out = forward(P, batch["images"], arch)
    targets = {k: batch[k] for k in ("labels", "masks", "valid")}
    if weak is None:
        return (*mask_criterion(out, targets, points, lw), out)
    return (*weak_criterion(
        out, batch["images"], targets, lw, projection_weight=weak.projection_weight,
        pairwise_weight=weak.pairwise_weight, color_thresh=weak.color_thresh,
        warmup_factor=warmup_factor(t, weak.warmup_iters),
        pix_thr=pix_thr(t, weak) if weak.mask_update else None), out)


def train_steps(P0: Mapping[str, torch.Tensor], batches: Sequence[Mapping[str, torch.Tensor]],
                points: Sequence[Optional[Mapping[str, torch.Tensor]]], arch: Arch,
                lw: LossWeights, opt: AdamWConfig, weak: Optional[WeakConfig] = None,
                numerics: Numerics = Numerics()) -> StepRecord:
    """len(batches) steps from the weights P0 (left unchanged), each
    forward, criterion and gradient computed in `numerics`."""
    P = {n: v.detach().clone() for n, v in P0.items()}
    names = trainable(P)
    adam = AdamW(names, P, opt)
    rec = StepRecord()
    for t, (batch, pts) in enumerate(zip(batches, points)):
        for n in names:
            P[n].requires_grad_(True)
        with numerics.scope():
            total, losses, out = loss_of(P, batch, pts, t, arch, lw, weak)
            grads = torch.autograd.grad(total, [P[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(P[n])).detach()
                 for n, g in zip(names, grads)}
        for n in names:
            P[n] = P[n].detach()
        norm, clipped = adam.step(P, grads)
        rec.total.append(float(total.detach()))
        rec.losses.append({k: float(v.detach()) for k, v in losses.items()})
        rec.grad_norm.append(float(norm))
        if t == 0:
            rec.grad1 = {n: float(clipped[n].norm()) for n in names}
            rec.out1 = {"masks0": first_head_masks(out).detach().float()}
        del grads, clipped, total, losses, out
    rec.change = {n: float((P[n] - P0[n]).norm()) for n in names}
    return rec
