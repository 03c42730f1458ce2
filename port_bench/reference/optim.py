"""AdamW with Mask2Former's parameter policy (train_net.py build_optimizer)
and optax's numerics, in plain PyTorch:

- the whole gradient clipped at global L2 norm `clip` (0.01): g x clip /
  |g| where |g| >= clip;
- Adam moments (betas 0.9, 0.999), bias-corrected, eps 1e-8 added to the
  square root;
- decoupled weight decay (0.05) added to the update from the parameter
  before the step, except on norms (GroupNorm, LayerNorm), embeddings
  (the query tables, both level embeddings) and, as upstream exempts them
  by name for every model, Swin's `relative_position_bias_table` and
  `absolute_pos_embed`;
- every weight trains but a frozen BatchNorm's folded constants: a
  backbone norm that holds a `scale` (a LayerNorm holds a `weight`, and
  trains), with its `bias`;
- the backbone's update at 0.1 of the learning rate;
- the learning rate of step t (updates made before it): base_lr x the
  linear warm-up factor over `warmup_iters` x gamma ** (milestones passed).

Departure from upstream, kept because the configuration states it: the
pixel decoder's `level_embed` is a bare parameter upstream and there takes
weight decay; the configuration exempts it as an embedding.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import torch

NO_DECAY = re.compile(r"(norm\d?|decoder_norm|input_proj\.\d+\.1)\.(weight|bias)$"
                      r"|(query_feat|query_embed|level_embed)(\.weight)?$"
                      r"|(relative_position_bias_table|absolute_pos_embed)$")
FOLDED_SCALE = re.compile(r"^backbone\..*\.norm\.scale$")


@dataclass(frozen=True)
class AdamWConfig:
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    backbone_multiplier: float = 0.1
    clip: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    steps: Tuple[int, ...] = (327778, 355092)
    gamma: float = 0.1


def trainable(names: Iterable[str]) -> List[str]:
    """The names, in order, less each folded norm's `scale` and `bias`."""
    names = list(names)
    folded = {n[:-len("scale")] for n in names if FOLDED_SCALE.search(n)}
    return [n for n in names if n.rpartition(".")[0] + "." not in folded]


def lr_at(cfg: AdamWConfig, t: int) -> float:
    warm = 1.0
    if t < cfg.warmup_iters:
        warm = cfg.warmup_factor + (1 - cfg.warmup_factor) * t / max(cfg.warmup_iters, 1)
    return cfg.base_lr * warm * cfg.gamma ** sum(t >= s for s in cfg.steps)


class AdamW:
    def __init__(self, names: List[str], params: Dict[str, torch.Tensor], cfg: AdamWConfig):
        self.cfg, self.names, self.t = cfg, names, 0
        self.mu = {n: torch.zeros_like(params[n]) for n in names}
        self.nu = {n: torch.zeros_like(params[n]) for n in names}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Updates `params` in place; returns the global gradient norm and
        the clipped gradient, by name."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        norm = torch.sqrt(sum((grads[n].double() ** 2).sum() for n in self.names)).float()
        factor = cfg.clip / norm if norm >= cfg.clip else torch.ones(())
        clipped = {n: grads[n] * factor for n in self.names}
        lr = lr_at(cfg, self.t)
        self.t += 1
        for n in self.names:
            g = clipped[n]
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.mu[n] / (1 - b1 ** self.t)) / ((self.nu[n] / (1 - b2 ** self.t)).sqrt()
                                                       + 1e-8)
            if not NO_DECAY.search(n):
                upd = upd + cfg.weight_decay * params[n]
            mult = cfg.backbone_multiplier if n.startswith("backbone.") else 1.0
            params[n].sub_(lr * mult * upd)
        return norm, clipped
