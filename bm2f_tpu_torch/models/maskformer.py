"""MaskFormer meta-architecture (reference: mask2former/maskformer_model.py:55-623)
in PyTorch.

The network is an `nn.Module` over normalized (B, H, W, 3) batches whose
sides are multiples of `size_divisibility` (NCHW inside); preprocessing is
`normalize_images`; the three inference modes are standalone functions with
fixed output shapes (validity masks instead of filtering), as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from bm2f_tpu_torch.config import Config, ModelConfig
from bm2f_tpu_torch.models.layers import init_parameters
from bm2f_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from bm2f_tpu_torch.models.resnet import (
    RESNET_FEATURE_CHANNELS,
    RESNET_FEATURE_STRIDES,
    ResNet,
)
from bm2f_tpu_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder
from bm2f_tpu_torch.ops import resize_bilinear


def normalize_images(images: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, H, W, 3) uint8/float RGB -> normalized float32."""
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std


def _check_supported(cfg: ModelConfig) -> None:
    """Parts of the JAX package that later slices of the port bring."""
    if cfg.backbone.name != "resnet":
        raise NotImplementedError(
            f"backbone {cfg.backbone.name!r}: Swin is ROADMAP queue 1 item 16")
    if cfg.pixel_decoder.name != "msdeform":
        raise NotImplementedError(
            f"pixel decoder {cfg.pixel_decoder.name!r}: the FPN and "
            "transformer-FPN decoders are ROADMAP queue 1 item 17")
    if cfg.decoder.name != "multi_scale_masked":
        raise NotImplementedError(
            f"decoder {cfg.decoder.name!r}: the standard decoder is ROADMAP "
            "queue 1 item 17")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"model.dtype {cfg.dtype!r}: bf16 is ROADMAP queue 1 item 10a")


class MaskFormerHead(nn.Module):
    """Pixel decoder + transformer predictor (reference:
    modeling/meta_arch/mask_former_head.py:115-132)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            cfg.pixel_decoder, RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES)
        C = cfg.pixel_decoder.conv_dim
        self.predictor = MultiScaleMaskedTransformerDecoder(
            cfg.decoder, cfg.num_classes, [C] * cfg.decoder.num_feature_levels)

    def forward(self, features: Dict[str, torch.Tensor], deform_impl: str = "auto"):
        mask_features, _, ms_feats = self.pixel_decoder(features, deform_impl)
        out = self.predictor(ms_feats, mask_features)
        out["mask_features"] = mask_features.permute(0, 2, 3, 1)  # NHWC, as JAX
        return out


class MaskFormer(nn.Module):
    """Backbone + head. Input: normalized (B, H, W, 3) with H, W divisible by
    `cfg.size_divisibility`. Output keys and shapes as the JAX model's."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone.resnet.depth,
                               cfg.backbone.resnet.out_features)
        self.sem_seg_head = MaskFormerHead(cfg)

    def forward(self, images: torch.Tensor,
                deform_impl: str = "auto") -> Dict[str, torch.Tensor]:
        """deform_impl="plain" forces the plain deformable-attention version
        on the card, for parity checks against the kernel."""
        x = images.float().permute(0, 3, 1, 2).contiguous()
        return self.sem_seg_head(self.backbone(x), deform_impl)


def build_model(cfg: Config, device="cuda", seed: int = 0) -> MaskFormer:
    """The model in eval mode on `device`, initialised from `seed` with a
    seeded `torch.Generator` (weights are drawn on the CPU, so a seed gives
    the same weights on every device)."""
    model = MaskFormer(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Inference (static shapes; reference: maskformer_model.py:509-623)
# ---------------------------------------------------------------------------


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """(..., Q, K+1), (..., Q, H, W) -> (..., H, W, K) semantic probabilities
    (reference :509-513: softmax x sigmoid einsum)."""
    probs = torch.softmax(mask_cls, dim=-1)[..., :-1]
    masks = torch.sigmoid(mask_pred)
    return torch.einsum("...qk,...qhw->...hwk", probs, masks)


def instance_topk_select(mask_cls: torch.Tensor, mask_pred: torch.Tensor, *,
                         num_classes: int, topk: int = 100):
    """Top-k over the flattened Q x K score matrix: (scores, labels, the
    selected mask logits)."""
    flat = torch.softmax(mask_cls, dim=-1)[:, :-1].reshape(-1)
    scores, idx = torch.topk(flat, min(topk, flat.shape[0]))
    labels = idx % num_classes
    qidx = idx // num_classes
    return scores, labels, mask_pred[qidx]


def instance_inference(
    mask_cls: torch.Tensor,
    mask_pred: torch.Tensor,
    *,
    num_classes: int,
    topk: int = 100,
    thing_mask: Optional[Tuple[bool, ...]] = None,
) -> Dict[str, torch.Tensor]:
    """Top-k over the flattened Q x K score matrix (reference :573-623).

    mask_cls: (Q, K+1); mask_pred: (Q, H, W) logits. Returns scores (topk,),
    labels (topk,), masks (topk, H, W) bool, valid (topk,) bool.
    """
    scores, labels, masks_logits = instance_topk_select(
        mask_cls, mask_pred, num_classes=num_classes, topk=topk)
    masks = masks_logits > 0
    valid = torch.ones_like(scores, dtype=torch.bool)
    if thing_mask is not None:
        tm = torch.tensor(thing_mask, dtype=torch.bool, device=labels.device)
        valid = valid & tm[labels]
    # mask-probability rescoring (reference :621)
    probs = torch.sigmoid(masks_logits)
    mf = masks.to(probs.dtype)
    mask_scores = (probs * mf).sum(dim=(1, 2)) / (mf.sum(dim=(1, 2)) + 1e-6)
    return {"scores": scores * mask_scores, "labels": labels, "masks": masks,
            "valid": valid}


def panoptic_inference(
    mask_cls: torch.Tensor,
    mask_pred: torch.Tensor,
    *,
    num_classes: int,
    thing_mask: Tuple[bool, ...],
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
) -> Dict[str, torch.Tensor]:
    """Vectorized panoptic fusion (reference :515-571): every step is a
    masked reduction over a static Q:
      1. keep queries confidently classified as a real class;
      2. pixel owner = argmax over kept queries of score-weighted sigmoid;
      3. drop queries whose claimed area shrank below overlap_threshold;
      4. merge stuff queries of the same class into the earliest query.

    Returns panoptic_quidx (H, W) int32 (owning query, -1 = void), valid
    (Q,) bool, classes (Q,) int32, isthing (Q,) bool, canonical (Q,) int32.
    `bm2f_tpu_torch.evaluation.panoptic_post.relabel_panoptic` turns them
    into contiguous segment ids.
    """
    Q = mask_cls.shape[0]
    dev = mask_cls.device
    probs = torch.softmax(mask_cls, dim=-1)
    scores = probs.amax(-1)
    labels = probs.argmax(-1)  # first maximum, as jnp.argmax
    masks = torch.sigmoid(mask_pred)  # (Q, H, W)

    keep = (labels != num_classes) & (scores > object_mask_threshold)
    prob_masks = scores[:, None, None] * masks
    owner = torch.where(keep[:, None, None], prob_masks,
                        torch.full_like(prob_masks, -1.0)).argmax(0)
    any_kept = keep.any()

    qids = torch.arange(Q, device=dev)
    owner_onehot = owner[None] == qids[:, None, None]  # (Q, H, W)
    binary = masks >= 0.5
    mask_area = owner_onehot.sum(dim=(1, 2))
    original_area = binary.sum(dim=(1, 2))
    final_area = (owner_onehot & binary).sum(dim=(1, 2))
    valid = (
        keep
        & (mask_area > 0)
        & (original_area > 0)
        & (final_area > 0)
        & (mask_area / original_area.clamp(min=1) >= overlap_threshold)
    )

    tm = torch.tensor(thing_mask, dtype=torch.bool, device=dev)
    isthing = tm[labels.clamp(0, num_classes - 1)] & (labels != num_classes)

    # stuff merging: canonical = smallest valid query index of the same class
    same_class = (labels[:, None] == labels[None, :]) & valid[None, :]
    first_same = same_class.to(torch.uint8).argmax(dim=1)
    has_same = same_class.any(dim=1)
    canonical = torch.where(isthing | ~has_same, qids, first_same)

    owner_valid = valid[owner] & any_kept
    owner_binary = torch.gather(binary, 0, owner[None])[0]
    pan = torch.where(owner_valid & owner_binary, canonical[owner],
                      torch.full_like(owner, -1))
    return {
        "panoptic_quidx": pan.to(torch.int32),
        "valid": valid,
        "classes": labels.to(torch.int32),
        "isthing": isthing,
        "canonical": canonical.to(torch.int32),
    }


def sem_seg_postprocess(logits_hw: torch.Tensor, pad_hw: Tuple[int, int],
                        img_hw: Tuple[int, int],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop the valid region out of the padded prediction and resize to the
    original image size (reference: detectron2 sem_seg_postprocess).
    logits_hw: (Q_or_C, Hpad, Wpad) -> (Q_or_C, out_h, out_w)."""
    x = logits_hw[:, :img_hw[0], :img_hw[1]]
    return resize_bilinear(x, out_hw[0], out_hw[1])
