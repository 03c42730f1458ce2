"""AdamW with the reference's parameter-group policy (reference:
train_net.py:184-263 `Trainer.build_optimizer`), with the JAX package's
semantics (bm2f_tpu/train/optim.py, an optax chain):

- full-model gradient clipping at global L2 norm `clip_gradients` as optax
  clips: g * (max / |g|) only when |g| >= max, with no epsilon (torch's
  `clip_grad_norm_` adds 1e-6 to the norm);
- Adam moments with eps 1e-8 outside the square root, bias-corrected;
- decoupled weight decay added to the update from the pre-update parameter;
- backbone parameters at `backbone_multiplier` (0.1x) LR;
- no weight decay on normalisation and embedding-like tensors. The JAX
  package picks them by path tokens (`norm`, `query_feat`, `query_embed`,
  `level_embed`, ...). Names do not carry over (the GroupNorm of
  `input_proj.N` is `input_proj.N.1`), so the port picks them by module:
  every GroupNorm, LayerNorm and Embedding, the pixel decoder's
  `level_embed` and Swin's `relative_position_bias_table` and
  `absolute_pos_embed` parameters;
- WarmupMultiStep or WarmupPoly LR schedule, as a function of the number of
  updates made before this one;
- under tensor parallelism, the global norm of the logical gradient over
  the rank's shares (`AdamW`).

The update runs on lists of tensors (`torch._foreach_*`), a handful of
launches for the whole model.
"""

from __future__ import annotations

from typing import Callable, Collection, Dict, List, Mapping, NamedTuple

import torch
import torch.distributed as dist
import torch.nn as nn

from bm2f_tpu_torch.config import OptimizerConfig

NO_DECAY_MODULES = (nn.GroupNorm, nn.LayerNorm, nn.Embedding)
# parameters held directly by a module that are not decayed
NO_DECAY_PARAMS = ("level_embed", "relative_position_bias_table", "absolute_pos_embed")


class ParamGroup(NamedTuple):
    name: str
    param: nn.Parameter
    lr_mult: float
    decay: bool


def param_groups(model: nn.Module, cfg: OptimizerConfig) -> List[ParamGroup]:
    """Every trainable parameter with its LR multiplier and whether it is
    decayed, in `named_parameters()` order."""
    out = []
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out.append(ParamGroup(
                name, p,
                cfg.backbone_multiplier if name.startswith("backbone.") else 1.0,
                not (isinstance(mod, NO_DECAY_MODULES) or leaf in NO_DECAY_PARAMS)))
    return out


def make_lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """WarmupMultiStep (COCO/YTVIS) or WarmupPolyLR (ADE20K/Cityscapes/
    Mapillary: base_lr * (1 - step/max_iter)^power, floored at
    constant_ending * base_lr)."""

    def schedule(step: int) -> float:
        if step < cfg.warmup_iters:
            warm = cfg.warmup_factor + (1.0 - cfg.warmup_factor) * step / max(
                cfg.warmup_iters, 1)
        else:
            warm = 1.0
        if cfg.lr_schedule == "poly":
            frac = min(max(step / max(cfg.max_iter, 1), 0.0), 1.0)
            decay = max((1.0 - frac) ** cfg.poly_power, cfg.poly_constant_ending)
        else:
            decay = cfg.gamma ** sum(step >= s for s in cfg.steps)
        return cfg.base_lr * warm * decay

    return schedule


class AdamW:
    """The optimizer over `param_groups(model, cfg)`. `step()` reads each
    parameter's `.grad` (a missing one counts as zeros), updates the
    parameters in place and returns the global gradient norm before
    clipping, as a 0-d tensor on the parameters' device.

    Under tensor parallelism the parameters named in `sharded` are this
    rank's shares of tensors split over `model_group`: the norm is then
    optax's `global_norm` of the whole (logical) tensors, each share's sum
    of squares summed over the group and each replicated parameter counted
    once, so that every rank clips by the same factor; the clip and the
    update act on the shares as they are."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig,
                 sharded: Collection[str] = (), model_group=None):
        if cfg.name != "adamw":
            raise NotImplementedError(f"optimizer {cfg.name!r}: only adamw")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.groups = param_groups(model, cfg)
        self.params = [g.param for g in self.groups]
        self.sharded = [g.name in sharded for g in self.groups]
        self.model_group = model_group
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates made so far

    def state_dict(self) -> Dict[str, object]:
        """The update count and both moments, by parameter name (optax's
        ScaleByAdamState: count, mu, nu); tensors are copies."""
        return {"count": self.count,
                "mu": {g.name: m.detach().clone() for g, m in zip(self.groups, self.mu)},
                "nu": {g.name: n.detach().clone() for g, n in zip(self.groups, self.nu)}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Restores `state_dict()`'s count and moments, bit for bit, into
        this optimizer's tensors. Raises unless it names exactly this
        optimizer's parameters."""
        names = [g.name for g in self.groups]
        for key in ("mu", "nu"):
            if sorted(state[key]) != sorted(names):
                raise KeyError(f"optimizer state {key} names other parameters than "
                               f"the model's: {sorted(set(state[key]) ^ set(names))[:5]}")
        for g, m, n in zip(self.groups, self.mu, self.nu):
            m.copy_(state["mu"][g.name])
            n.copy_(state["nu"][g.name])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        cfg = self.cfg
        b1, b2 = cfg.betas
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        # sqrt of the sum of squares, as optax.global_norm (torch's f32
        # vector_norm on the CPU is off by ~1e-5 relative for small values)
        if any(self.sharded):
            g_norm = self._sharded_sq_sum(grads).sqrt()
        else:
            flat = torch.cat([g.reshape(-1) for g in grads])
            g_norm = flat.square().sum().sqrt()
            del flat
        # optax clip_by_global_norm: (g / |g|) * max where |g| >= max, else g
        clip = g_norm >= cfg.clip_gradients
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(clip, g_norm, 1.0)),
            torch.where(clip, cfg.clip_gradients, 1.0))

        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, 1e-8)
        updates = torch._foreach_div(mu_hat, nu_hat)

        decay = [cfg.weight_decay if g.decay else 0.0 for g in self.groups]
        torch._foreach_add_(updates, torch._foreach_mul(self.params, decay))
        torch._foreach_mul_(updates, [g.lr_mult for g in self.groups])
        torch._foreach_add_(self.params, updates, alpha=-self.schedule(self.count - 1))
        return g_norm

    def _sharded_sq_sum(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's sum of squares: the shares' summed over the
        model group, the replicated parameters' once."""
        def sq(keep):
            return torch.cat([g.reshape(-1) for g, s in zip(grads, self.sharded)
                              if s == keep]).square().sum()

        shares = sq(True)
        dist.all_reduce(shares, group=self.model_group)
        return sq(False) + shares
