"""The train step on one device: the counterpart of the JAX package's
`make_train_step` / `Trainer` (bm2f_tpu/train/trainer.py:36-152) for
mask-supervised image training (`model.loss.sup_type == "mask"`).

A step is: forward, matcher costs, the assignment (`train.matcher`:
`matching.hungarian.make_assign_fn`), losses, backward, clip + AdamW. It
returns the same metrics as the JAX step: every loss, `total_loss` and
`grad_norm` (before clipping). The deformable encoder layers run K1 forward
and K2 backward on the card (`ops.deform_attn.MSDeformAttnFunction`), which
saves only each layer's inputs; the port does not rematerialise
(`PixelDecoderConfig.remat` only changes memory, and the JAX package needs
it for the gathered rows its formulation keeps).

`model.dtype` "bfloat16" trains as the JAX bench does: the model computes
in bf16 (K1 and K2 on a bf16 `value` when the pixel decoder does too), its
parameters and the AdamW moments stay f32, as in the JAX `TrainState`, and
there is no loss scaling, as there is none in JAX. An f32 model computes in
f32 (`utils.precision.f32_scope`: no TF32), whatever the global flags say.
`state_dict()` holds what the JAX `TrainState` holds, for
`train.checkpoint.Checkpointer`.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bm2f_tpu_torch.config import Config
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, set_criterion
from bm2f_tpu_torch.matching.hungarian import make_assign_fn
from bm2f_tpu_torch.models.maskformer import build_model, normalize_images
from bm2f_tpu_torch.train.optim import AdamW
from bm2f_tpu_torch.utils.precision import f32_scope

log = logging.getLogger(__name__)


def criterion_config(cfg: Config) -> SetCriterionConfig:
    lc = cfg.model.loss
    return SetCriterionConfig(
        num_classes=cfg.model.num_classes,
        eos_coef=lc.no_object_weight,
        class_weight=lc.class_weight,
        mask_weight=lc.mask_weight,
        dice_weight=lc.dice_weight,
        num_points=lc.train_num_points,
        oversample_ratio=lc.oversample_ratio,
        importance_sample_ratio=lc.importance_sample_ratio,
    )


def _check_trainable(cfg: Config) -> None:
    """Branches of the JAX train step that later slices of the port bring."""
    if cfg.task == "video":
        raise NotImplementedError(
            "video training: ROADMAP queue 1 item 18 (video criterion)")
    if cfg.model.loss.sup_type != "mask":
        raise NotImplementedError(
            f"sup_type {cfg.model.loss.sup_type!r}: weak supervision is ROADMAP "
            "queue 1 item 19")


def synthetic_batch(batch: int, size: int, instances: int, seed: int,
                    num_classes: int = 80, device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded batch in the JAX bench's train recipe (bench.py:315-330):
    uint8-range float images (B, size, size, 3), labels in 0..num_classes-1,
    masks `rand > 0.8`. The last 2 targets of image 0 are padding (invalid;
    fewer when it has fewer than 3), so that the matcher's PAD_COST columns are exercised."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, size, size, 3).astype(np.float32) * 255
    labels = rng.randint(0, num_classes, (batch, instances))
    masks = rng.rand(batch, instances, size, size) > 0.8
    valid = np.ones((batch, instances), bool)
    valid[0, max(instances - 2, 1):] = False
    return {
        "images": torch.from_numpy(images).to(device),
        "labels": torch.from_numpy(labels).to(device),
        "masks": torch.from_numpy(masks).to(device=device, dtype=torch.float32),
        "valid": torch.from_numpy(valid).to(device),
    }


class StageTimer:
    """Host-clock time of consecutive stages, with a device synchronise at
    every mark (so that each stage's device work is charged to it). Costs
    one synchronise per mark; the train step takes none without it."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms: Dict[str, float] = {}
        self.start()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + (now - self._t) * 1e3
        self._t = now


class Trainer:
    """`coco_instance_r50`-style mask-supervised training on one device.
    The model is drawn from `seed` (`build_model`); the criterion's random
    points come from a `torch.Generator` on `device` seeded with `seed`."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        _check_trainable(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, device=self.device, seed=seed).train()
        self.ccfg = criterion_config(cfg)
        self.assign_fn = make_assign_fn(cfg)
        self.optimizer = AdamW(self.model, cfg.train.optimizer)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        log.info("training without rematerialisation: each deformable "
                 "encoder layer saves only its inputs for K2")

    @property
    def step_count(self) -> int:
        """Steps taken (the JAX `TrainState.step`)."""
        return self.optimizer.count

    def state_dict(self) -> Dict[str, object]:
        """What the JAX `TrainState` holds: the step, the parameters and the
        FrozenBN buffers (the model's `state_dict`), the AdamW moments and
        count, and the criterion generator's state (JAX's `rng`)."""
        return {"step": self.step_count, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Restores `state_dict()` bit for bit; raises on a missing or an
        extra key or a step that disagrees with the optimizer's count."""
        if int(state["step"]) != int(state["optimizer"]["count"]):
            raise ValueError(f"step {state['step']} but the optimizer has made "
                             f"{state['optimizer']['count']} updates")
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])

    def loss(self, batch: Mapping[str, torch.Tensor],
             points: Optional[Mapping[str, torch.Tensor]] = None,
             deform_impl: str = "auto",
             mark: Optional[Callable[[str], None]] = None,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward + criterion: (total_loss, losses). `points` as
        `draw_points` gives them (drawn from the trainer's generator when
        None); deform_impl="plain" runs the plain deformable attention (a
        parity reference for the kernels)."""
        out = self.model(normalize_images(batch["images"], self.cfg.model), deform_impl)
        if mark is not None:
            mark("forward")
        if points is None:
            points = draw_points(self.ccfg, out["aux_logits"].shape[0] + 1,
                                 out["pred_logits"].shape[0], self.generator)
        targets = {k: batch[k] for k in ("labels", "masks", "valid")}
        return set_criterion(out, targets, self.ccfg, points, mark, self.assign_fn)

    def step(self, batch: Mapping[str, torch.Tensor],
             points: Optional[Mapping[str, torch.Tensor]] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step. Returns every loss, total_loss and grad_norm
        as 0-d device tensors. `mark(stage)`, when given, is called after
        forward, matcher_costs, assign, losses, backward and optimizer."""
        with f32_scope(self.cfg.model.dtype):
            self.optimizer.zero_grad()
            total, losses = self.loss(batch, points, mark=mark)
            total.backward()
            if mark is not None:
                mark("backward")
            grad_norm = self.optimizer.step()
            if mark is not None:
                mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics
