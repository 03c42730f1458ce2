"""The choice of criterion: `build_criterion` maps a config's task (image
or "video") and `model.loss.sup_type` to one of the four set criteria
(`CRITERIA`), bound to the config's weights, as the JAX `compute_loss`
dispatches (bm2f_tpu/train/trainer.py)."""

from __future__ import annotations

from typing import Callable

import torch

from bm2f_tpu_torch.config import Config
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, set_criterion
from bm2f_tpu_torch.losses.target_prep import build_video_weaksup_targets, build_weaksup_targets
from bm2f_tpu_torch.losses.video_criterion import video_set_criterion
from bm2f_tpu_torch.losses.weaksup import mask_update_pix_thr, pairwise_warmup_factor
from bm2f_tpu_torch.losses.weaksup_criterion import weaksup_set_criterion
from bm2f_tpu_torch.losses.weaksup_video import video_weaksup_set_criterion


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


def _mask(cfg: Config, assign_fn, generator):
    video = cfg.task == "video"
    criterion = video_set_criterion if video else set_criterion
    ccfg = criterion_config(cfg)

    def loss(out, batch, points, step):
        if points is None:
            frames = out["pred_masks"].shape[2] if video else 1
            points = draw_points(ccfg, out["aux_logits"].shape[0] + 1,
                                 out["pred_logits"].shape[0], generator, frames)
        targets = {k: batch[k] for k in ("labels", "masks", "valid")}
        return criterion(out, targets, ccfg, points, assign_fn)

    return loss


def _weak(cfg: Config, assign_fn, generator):
    ccfg, weak = criterion_config(cfg), cfg.model.loss.weak
    pw = weak.pairwise
    video = cfg.task == "video"

    def loss(out, batch, points, step):
        args = [batch[k] for k in ("images", "labels", "masks", "valid")]
        # read at the step before its update, as JAX reads `state.step`
        kw = dict(sup_type=cfg.model.loss.sup_type, projection_weight=weak.projection_weight,
                  pairwise_weight=weak.pairwise_weight, color_thresh=pw.color_thresh,
                  kernel_size=pw.size, dilation=pw.dilation, assign_fn=assign_fn,
                  warmup_factor=pairwise_warmup_factor(step, pw.warmup_iters))
        if video:
            targets = build_video_weaksup_targets(*args, batch.get("dino_feats"),
                                                  kernel_size=pw.size, dilation=pw.dilation)
            return video_weaksup_set_criterion(
                out, targets, ccfg, temporal_pairwise_weight=weak.temporal_pairwise_weight, **kw)
        targets = build_weaksup_targets(*args, kernel_size=pw.size, dilation=pw.dilation)
        pix_thr = None
        if weak.mask_update_enabled:
            pix_thr = mask_update_pix_thr(step, cfg.train.optimizer.max_iter,
                                          weak.mask_update_steps, weak.mask_update_pix_thrs)
        return weaksup_set_criterion(out, targets, ccfg, mask_update_pix_thr=pix_thr, **kw)

    return loss


# (image or video, `model.loss.sup_type`) -> the builder of its criterion
CRITERIA = {
    ("image", "mask"): _mask,
    ("image", "mask_projection"): _weak,
    ("image", "mask_projection_and_pairwise"): _weak,
    ("video", "mask"): _mask,
    ("video", "mask_projection"): _weak,
    ("video", "mask_projection_and_spatial_pairwise"): _weak,
    ("video", "mask_projection_and_spatial_pairwise_and_temporal_pairwise"): _weak,
}


def build_criterion(cfg: Config, assign_fn: Callable[[torch.Tensor], torch.Tensor],
                    generator: torch.Generator):
    """`criterion(out, batch, points, step)` -> (total, losses) of `cfg`'s
    task and sup_type on the model's outputs and a train batch (images,
    labels, masks, valid[, dino_feats]; the weak targets are built from
    it). The mask criteria draw `points` from `generator` when None; the
    weak ones read their warmup and pixel threshold at `step`. Raises
    ValueError on a sup_type the task has no criterion for."""
    kind = "video" if cfg.task == "video" else "image"
    sup = cfg.model.loss.sup_type
    if (kind, sup) not in CRITERIA:
        known = tuple(s for k, s in CRITERIA if k == kind)
        raise ValueError(f"sup_type {sup!r} for task {cfg.task!r}: one of {known}")
    return CRITERIA[kind, sup](cfg, assign_fn, generator)
