"""`losses.build.build_criterion`: the criterion of each (task, sup_type)
pair, on a tiny model with two decoder layers on the CPU. Each pair's
criterion names its losses as the four set criteria always have, layer by
layer with the aux layers first; its total is the weighted sum of its
terms; `Trainer.loss` is the forward and then that criterion; and a
sup_type a task has no criterion for is refused when the trainer is
built."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.losses.build import build_criterion
from bm2f_tpu_torch.losses.criterion import draw_points
from bm2f_tpu_torch.models.maskformer import normalize_images
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch

# a tiny head on a depth-14 ResNet: one encoder and two decoder layers (three
# supervised layers), six queries, 64 points; the pairwise warmup at half
# way through step 5
TINY = {
    "model.backbone.resnet.depth": 14,
    "model.pixel_decoder.conv_dim": 32,
    "model.pixel_decoder.mask_dim": 32,
    "model.pixel_decoder.transformer_enc_layers": 1,
    "model.pixel_decoder.transformer_dim_feedforward": 64,
    "model.decoder.hidden_dim": 32,
    "model.decoder.mask_dim": 32,
    "model.decoder.dim_feedforward": 64,
    "model.decoder.dec_layers": 2,
    "model.decoder.num_queries": 6,
    "model.loss.train_num_points": 64,
    "input.max_instances": 4,
    "model.loss.weak.pairwise.warmup_iters": 10,
}
STEP = 5

# (preset, task, sup_type, the loss names in order)
PAIRS = [
    ("coco_instance_r50", "instance", "mask", [
        "loss_ce_0", "loss_mask_0", "loss_dice_0",
        "loss_ce_1", "loss_mask_1", "loss_dice_1",
        "loss_ce", "loss_mask", "loss_dice"]),
    ("coco_instance_r50_wo_lsj_proj", "instance", "mask_projection", [
        "loss_ce_0", "loss_mask_projection_0",
        "loss_ce_1", "loss_mask_projection_1",
        "loss_ce", "loss_mask_projection"]),
    ("coco_instance_r50_wo_lsj_projpair", "instance", "mask_projection_and_pairwise", [
        "loss_ce_0", "loss_mask_projection_0", "loss_pairwise_0",
        "loss_ce_1", "loss_mask_projection_1", "loss_pairwise_1",
        "loss_ce", "loss_mask_projection", "loss_pairwise"]),
    ("ytvis2019_video_r50", "video", "mask", [
        "loss_ce_0", "loss_mask_0", "loss_dice_0",
        "loss_ce_1", "loss_mask_1", "loss_dice_1",
        "loss_ce", "loss_mask", "loss_dice"]),
    ("ytvis2021_video_r50_proj", "video", "mask_projection", [
        "loss_ce_0", "loss_mask_projection_0",
        "loss_ce_1", "loss_mask_projection_1",
        "loss_ce", "loss_mask_projection"]),
    ("ytvis2021_video_r50_proj_spatpair", "video", "mask_projection_and_spatial_pairwise", [
        "loss_ce_0", "loss_mask_projection_0", "loss_mask_spatial_pairwise_0",
        "loss_ce_1", "loss_mask_projection_1", "loss_mask_spatial_pairwise_1",
        "loss_ce", "loss_mask_projection", "loss_mask_spatial_pairwise"]),
    ("ytvis2021_video_r50_proj_spatpair_temppair", "video",
     "mask_projection_and_spatial_pairwise_and_temporal_pairwise", [
         "loss_ce_0", "loss_mask_projection_0", "loss_mask_spatial_pairwise_0",
         "loss_mask_temporal_pairwise_0",
         "loss_ce_1", "loss_mask_projection_1", "loss_mask_spatial_pairwise_1",
         "loss_mask_temporal_pairwise_1",
         "loss_ce", "loss_mask_projection", "loss_mask_spatial_pairwise",
         "loss_mask_temporal_pairwise",
         "temp_pair_valid_prop"]),
]
IDS = ["image_mask", "image_proj", "image_projpair", "video_mask", "video_proj",
       "video_spatpair", "video_temppair"]


def _image_batch():
    return synthetic_batch(2, 64, 4, seed=3, num_classes=80, device="cpu")


def _clip_batch(T=2, size=64, G=3):
    """Two still clips of T frames: images of flat 16x16 blocks (so that
    neighbouring pixels share colours and the pairwise losses have edges),
    random boxes, 1 of clip 0's G targets padding, and integer DINO-like
    (2, T, 16, 16, 8) grids (each patch's match in the next frame is
    itself, so the temporal loss has pairs)."""
    rng = np.random.RandomState(3)
    valid = np.ones((2, G), bool)
    valid[0, G - 1] = False
    masks = np.zeros((2, G, T, size, size), np.float32)
    for b in range(2):
        for g in range(G):
            y, x = rng.randint(0, size // 2, 2)
            h, w = rng.randint(8, size // 2, 2)
            masks[b, g, :, y:y + h, x:x + w] = 1.0
    blocks = rng.randint(0, 256, (2, 1, size // 16, size // 16, 3)).astype(np.float32)
    images = np.repeat(np.repeat(blocks, 16, 2), 16, 3).repeat(T, 1)
    dino = rng.randint(-2, 3, (2, 1, 16, 16, 8)).astype(np.float32).repeat(T, 1)
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(rng.randint(0, 40, (2, G))),
            "masks": torch.from_numpy(masks), "valid": torch.from_numpy(valid),
            "dino_feats": torch.from_numpy(dino)}


def _weights(cfg, name):
    """The weight of the term `name` (without its layer suffix) in the total."""
    lc, weak = cfg.model.loss, cfg.model.loss.weak
    return {"loss_ce": lc.class_weight, "loss_mask": lc.mask_weight,
            "loss_dice": lc.dice_weight, "loss_mask_projection": weak.projection_weight,
            "loss_pairwise": weak.pairwise_weight,
            "loss_mask_spatial_pairwise": weak.pairwise_weight,
            "loss_mask_temporal_pairwise": weak.temporal_pairwise_weight}[name]


_CASES = {}


def _case(preset):
    """(trainer at step STEP, batch, the mask criteria's points or None, the
    model's outputs on the batch), built once a preset."""
    if preset not in _CASES:
        cfg = get_config(preset, TINY)
        trainer = Trainer(cfg, device="cpu")
        trainer.optimizer.count = STEP
        video = cfg.task == "video"
        batch = _clip_batch() if video else _image_batch()
        points = None
        if cfg.model.loss.sup_type == "mask":
            points = draw_points(trainer.ccfg, cfg.model.decoder.dec_layers + 1, 2,
                                 torch.Generator().manual_seed(4), 2 if video else 1)
        with torch.no_grad():
            out = trainer.forward(normalize_images(batch["images"], cfg.model))
        _CASES[preset] = trainer, batch, points, out
    return _CASES[preset]


@pytest.mark.parametrize("preset,task,sup_type,names", PAIRS, ids=IDS)
def test_each_pair_names_its_losses_layer_by_layer(preset, task, sup_type, names):
    trainer, batch, points, out = _case(preset)
    assert (trainer.cfg.task, trainer.cfg.model.loss.sup_type) == (task, sup_type)
    _, losses = trainer.criterion(out, batch, points, STEP)
    assert list(losses) == names


@pytest.mark.parametrize("preset,task,sup_type,names", PAIRS, ids=IDS)
def test_each_pairs_total_is_the_weighted_sum_of_its_terms(preset, task, sup_type, names):
    trainer, batch, points, out = _case(preset)
    total, losses = trainer.criterion(out, batch, points, STEP)
    want = sum(_weights(trainer.cfg, name.rsplit("_", 1)[0] if name[-1].isdigit() else name)
               * term.double() for name, term in losses.items()
               if name != "temp_pair_valid_prop")
    assert all(torch.isfinite(t) and t > 0 for t in losses.values())
    torch.testing.assert_close(total.double(), want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("preset,task,sup_type,names", PAIRS, ids=IDS)
def test_trainer_loss_is_the_forward_then_the_criterion(preset, task, sup_type, names):
    trainer, batch, points, out = _case(preset)
    total, losses = trainer.loss(batch, points)
    want_total, want = trainer.criterion(out, batch, points, trainer.step_count)
    assert torch.equal(total, want_total)
    assert list(losses) == list(want)
    for name in want:
        assert torch.equal(losses[name], want[name]), name


@pytest.mark.parametrize("preset,sup_type", [
    ("coco_instance_r50", "mask_projection_and_spatial_pairwise"),
    ("ytvis2019_video_r50", "mask_projection_and_pairwise"),
], ids=["image", "video"])
def test_a_sup_type_the_task_has_no_criterion_for_is_refused(preset, sup_type):
    cfg = get_config(preset, {**TINY, "model.loss.sup_type": sup_type})
    with pytest.raises(ValueError, match=f"sup_type '{sup_type}' for task '{cfg.task}'"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="one of"):
        build_criterion(cfg, lambda costs: costs, torch.Generator())
