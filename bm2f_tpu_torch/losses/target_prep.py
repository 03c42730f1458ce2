"""Weak-supervision targets on the device, batched (bm2f_tpu/losses/
target_prep.py; reference: maskformer_model.py:399-507
prepare_weaksup_targets, which calls skimage rgb2lab on the host per image
and loops over instances): the LAB conversion, the color similarity, and
box masks with projection bounds at stride 4, the predicted masks' stride.
"""

from __future__ import annotations

from typing import Dict

import torch

from bm2f_tpu_torch.losses.weaksup import (
    box_targets_from_masks,
    get_images_color_similarity,
    rgb_to_lab,
)


def build_weaksup_targets(images: torch.Tensor, labels: torch.Tensor,
                          gt_box_masks: torch.Tensor, valid: torch.Tensor, *,
                          stride: int = 4, kernel_size: int = 3,
                          dilation: int = 2) -> Dict[str, torch.Tensor]:
    """Image weak-supervision targets at the stride of the predicted masks.
    images (B, H, W, 3) raw RGB in [0, 255] (before `normalize_images`),
    labels (B, G), gt_box_masks (B, G, H, W) box (or full) masks, valid
    (B, G). Returns labels, valid, box_masks (B, G, h, w), left/right_bounds
    (B, G, h), top/bottom_bounds (B, G, w) and color_similarity (B, h, w,
    K)."""
    B, G = labels.shape
    t = box_targets_from_masks(gt_box_masks.reshape(B * G, *gt_box_masks.shape[2:]),
                               stride=stride)
    start = stride // 2
    lab = rgb_to_lab(images[:, start::stride, start::stride].float() / 255.0)
    return {"labels": labels, "valid": valid,
            **{k: v.reshape(B, G, *v.shape[1:]) for k, v in t.items()},
            "color_similarity": get_images_color_similarity(lab, kernel_size, dilation)}


def build_video_weaksup_targets(*args, **kwargs):
    """The video targets (temporal pairs from DINO features) are not ported."""
    raise NotImplementedError(
        "video weak-supervision targets: ROADMAP queue 1 items 18 (video) and 19 "
        "(weak supervision, its video half)")
