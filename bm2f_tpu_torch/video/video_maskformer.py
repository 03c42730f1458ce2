"""Video MaskFormer (reference: mask2former_video/video_maskformer_model_WithColor.py,
the active implementation), as the JAX package computes it
(bm2f_tpu/video/video_maskformer.py).

B clips x T frames go through the backbone and the pixel decoder as ONE
batch of B*T images (reference :316-324), so K1 launches once per encoder
layer whatever T is; the three levels and the mask features are then
reshaped to (B, T, ...) for the video decoder, which attends over the whole
clip. The model computes in `model.dtype` with the pixel decoder in f32 when
`pixel_decoder_f32` is set, as the image model does, and its parameters
carry the image model's names. `inference_video` keeps the top-k (Q x K)
scores as tracks and thresholds the masks at 0 (reference :651-694).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bm2f_tpu_torch.config import Config
from bm2f_tpu_torch.models.layers import init_parameters
from bm2f_tpu_torch.models.maskformer import MaskFormer, MaskFormerHead
from bm2f_tpu_torch.utils import tracing
from bm2f_tpu_torch.video.video_decoder import VideoMultiScaleMaskedTransformerDecoder


class VideoMaskFormerHead(MaskFormerHead):
    predictor_cls = VideoMultiScaleMaskedTransformerDecoder


class VideoMaskFormer(MaskFormer):
    """Backbone + head over clips. Input: normalized (B, T, H, W, 3) with H,
    W divisible by `cfg.size_divisibility`, and optionally `frame_valid`
    (B, T) bool, False on padded frames. Output keys and shapes as the JAX
    video model's: pred_masks (B, Q, T, h4, w4), mask_features (B, T, h4,
    w4, mask_dim)."""

    head_cls = VideoMaskFormerHead
    # the JAX video head builds these two whatever the config names
    # (bm2f_tpu/video/video_maskformer.py:57-72); other names raise here
    pixel_decoders = ("msdeform",)
    decoders = ("multi_scale_masked",)

    def forward(self, images: torch.Tensor, frame_valid: Optional[torch.Tensor] = None,
                deform_impl: str = "auto") -> Dict[str, torch.Tensor]:
        B, T = images.shape[:2]
        x = images.float().flatten(0, 1).permute(0, 3, 1, 2).contiguous()
        head = self.sem_seg_head
        with tracing.span("net.backbone"):
            features = self.backbone(x)
        with tracing.span("net.pixel_decoder"):
            mask_features, _, ms_feats = head.pixel_decoder(features, deform_impl)
        ms_feats = [f.reshape(B, T, *f.shape[1:]) for f in ms_feats]
        mask_features = mask_features.reshape(B, T, *mask_features.shape[1:])
        with tracing.span("net.decoder"):
            out = head.predictor(ms_feats, mask_features, frame_valid)
        out["mask_features"] = mask_features.permute(0, 1, 3, 4, 2)  # as JAX
        return out


def build_video_model(cfg: Config, device="cuda", seed: int = 0) -> VideoMaskFormer:
    """The video model in eval mode on `device`, initialised from `seed` as
    `build_model` initialises the image model (the same seed gives the same
    weights to both)."""
    model = VideoMaskFormer(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the 1-D `x`, the lower
    index first among equal values (as `jax.lax.top_k`; `torch.topk`
    promises no order among ties)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def track_topk(mask_cls: torch.Tensor, *, num_classes: int, topk: int = 10):
    """The tracks' (scores, labels, queries): the top-k of the flattened
    (Q x K) score matrix of mask_cls (Q, K+1). The masks take no part."""
    flat = torch.softmax(mask_cls, dim=-1)[:, :-1].reshape(-1)
    scores, idx = topk_stable(flat, topk)
    return scores, idx % num_classes, idx // num_classes


def inference_video(mask_cls: torch.Tensor, mask_pred: torch.Tensor, *,
                    num_classes: int, topk: int = 10) -> Dict[str, torch.Tensor]:
    """Track inference: top-k over the flattened (Q x K) score matrix, each
    track the thresholded per-frame masks of its query.
    mask_cls (Q, K+1); mask_pred (Q, T, H, W) logits. Returns scores (k,),
    labels (k,), masks (k, T, H, W) bool."""
    scores, labels, queries = track_topk(mask_cls, num_classes=num_classes, topk=topk)
    return {"scores": scores, "labels": labels, "masks": mask_pred[queries] > 0.0}
