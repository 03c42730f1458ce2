"""Weak-supervision targets on the device, batched (bm2f_tpu/losses/
target_prep.py; reference: maskformer_model.py:399-507
prepare_weaksup_targets, which calls skimage rgb2lab on the host per image
and loops over instances): the LAB conversion, the color similarity, and
box masks with projection bounds at stride 4, the predicted masks' stride,
and for video the same per frame plus the DINO temporal pairs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bm2f_tpu_torch.losses.weaksup import (
    box_targets_from_masks,
    get_images_color_similarity,
    rgb_to_lab,
)
from bm2f_tpu_torch.losses.weaksup_video import compute_temporal_pairs


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


def build_video_weaksup_targets(images: torch.Tensor, labels: torch.Tensor,
                                gt_box_masks: torch.Tensor, valid: torch.Tensor,
                                dino_feats: Optional[torch.Tensor] = None, *,
                                stride: int = 4, kernel_size: int = 3, dilation: int = 2,
                                num_pairs: int = 128,
                                color_thresh: float = 0.3) -> Dict[str, torch.Tensor]:
    """Video weak-supervision targets (reference: video_maskformer_model.py:
    395-620, get_instance_temporal_pairs weaksup_utils.py:157). images (B,
    T, H, W, 3) raw RGB, labels (B, G), gt_box_masks (B, G, T, H, W), valid
    (B, G), dino_feats (B, T, Hp, Wp, C) or None. Returns labels, valid,
    box_masks (B, G, T, h, w), the bounds (B, G, T, h|w) and
    color_similarity (B, T, h, w, K) per frame; with features and T >= 2
    also temporal_pairs (B, G, T-1, num_pairs, 4) [x_t, y_t, x_t1, y_t1] in
    mask coordinates and temporal_pairs_valid (B, G, T-1, num_pairs), from
    the boxes and the LAB image subsampled (nearest) to the patch grid."""
    B, T = images.shape[:2]
    G = labels.shape[1]
    t = box_targets_from_masks(gt_box_masks.reshape(B * G * T, *gt_box_masks.shape[3:]),
                               stride=stride)
    start = stride // 2
    lab = rgb_to_lab(images[:, :, start::stride, start::stride].float() / 255.0)
    color_sim = get_images_color_similarity(lab.flatten(0, 1), kernel_size, dilation)
    out = {"labels": labels, "valid": valid,
           **{k: v.reshape(B, G, T, *v.shape[1:]) for k, v in t.items()},
           "color_similarity": color_sim.reshape(B, T, *color_sim.shape[1:])}
    if dino_feats is None or T < 2:
        return out

    Hp, Wp = dino_feats.shape[2:4]
    h4, w4 = out["box_masks"].shape[-2:]
    dev = images.device
    ar_h, ar_w = torch.arange(Hp, device=dev), torch.arange(Wp, device=dev)
    # boxes and colors on the DINO patch grid (nearest subsample)
    boxes_p = out["box_masks"][..., (ar_h * h4) // Hp, :][..., (ar_w * w4) // Wp] > 0.5
    lab_p = lab[:, :, (ar_h * lab.shape[2]) // Hp][:, :, :, (ar_w * lab.shape[3]) // Wp]
    feats = dino_feats.float()
    pairs, pvalid = compute_temporal_pairs(
        feats[:, None, :-1], feats[:, None, 1:],  # (B, 1, T-1, Hp, Wp, C)
        boxes_p[:, :, :-1], boxes_p[:, :, 1:],  # (B, G, T-1, Hp, Wp)
        num_pairs, lab_p[:, None, :-1], lab_p[:, None, 1:], color_thresh)
    # patch coordinates -> mask (stride) coordinates, truncated as JAX's cast
    px = (pairs[..., 0::2].float() * (w4 / Wp)).to(torch.int32).clamp(0, w4 - 1)
    py = (pairs[..., 1::2].float() * (h4 / Hp)).to(torch.int32).clamp(0, h4 - 1)
    out["temporal_pairs"] = torch.stack([px[..., 0], py[..., 0], px[..., 1], py[..., 1]], -1)
    out["temporal_pairs_valid"] = pvalid & valid[:, :, None, None]
    return out
