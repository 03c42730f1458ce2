"""MaskFormer-v1 architectures (reference: maskformer_transformer_decoder.py:31
StandardTransformerDecoder, fpn.py:205 TransformerEncoderPixelDecoder,
per_pixel_baseline.py:18/:127 PerPixelBaselineHead /
PerPixelBaselinePlusHead), as the JAX package's `models/maskformer_v1.py`
computes them. NCHW features in, the JAX modules' outputs out.

Parameter names follow upstream MaskFormer:
`pixel_decoder.input_proj`, `pixel_decoder.transformer.encoder.layers.{i}`,
`predictor.transformer.decoder.layers.{i}`, `predictor.transformer.decoder.norm`,
`predictor.query_embed.weight`, `predictor.input_proj`, `predictor.class_embed`,
`predictor.mask_embed.layers.{j}`. The 1x1 `input_proj` convs and the
per-pixel classifier start c2-xavier, as the JAX modules' (`c2_xavier_init`,
read by `layers.init_parameters`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from bm2f_tpu_torch.config import DecoderConfig, PixelDecoderConfig
from bm2f_tpu_torch.models.layers import MLP, Conv2d, Linear, cast
from bm2f_tpu_torch.models.pixel_decoder import BasePixelDecoder
from bm2f_tpu_torch.models.position_encoding import sine_position_embedding_2d
from bm2f_tpu_torch.models.transformer import TransformerDecoder, TransformerEncoder


def _c2_xavier_conv(c_in: int, c_out: int) -> Conv2d:
    conv = Conv2d(c_in, c_out, 1)
    conv.c2_xavier_init = True
    return conv


class _EncoderOnly(nn.Module):
    """Holds the encoder as upstream's `TransformerEncoderOnly` does."""

    def __init__(self, encoder: TransformerEncoder):
        super().__init__()
        self.encoder = encoder


class _DecoderOnly(nn.Module):
    """Holds the decoder as upstream's `Transformer` does (MaskFormer's
    standard decoder builds it with no encoder layers)."""

    def __init__(self, decoder: TransformerDecoder):
        super().__init__()
        self.decoder = decoder


class StandardTransformerDecoder(nn.Module):
    """DETR-style decoder head (reference:
    maskformer_transformer_decoder.py:31-188): Q queries attend to ONE
    feature level; masks are every layer's mask embedding against the
    stride-4 mask features.

    forward(x (B, Ci, H, W), mask_features (B, mask_dim, H4, W4)) returns
    pred_masks (B, Q, H4, W4) and aux_masks (L-1, B, Q, H4, W4), and with
    `mask_classification` pred_logits (B, Q, K+1) and aux_logits
    (L-1, B, Q, K+1); all f32. `num_queries` > 0 overrides the config's."""

    def __init__(self, cfg: DecoderConfig, num_classes: int, in_channels: int,
                 dtype: torch.dtype = torch.float32, mask_classification: bool = True,
                 num_queries: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        C = cfg.hidden_dim
        self.num_queries = num_queries or cfg.num_queries
        self.mask_classification = mask_classification
        self.transformer = _DecoderOnly(TransformerDecoder(
            cfg.dec_layers, C, cfg.nheads, cfg.dim_feedforward, cfg.pre_norm))
        self.query_embed = nn.Embedding(self.num_queries, C)
        self.input_proj = (_c2_xavier_conv(in_channels, C)
                           if in_channels != C or cfg.enforce_input_project else None)
        self.class_embed = Linear(C, num_classes + 1) if mask_classification else None
        self.mask_embed = MLP(C, C, cfg.mask_dim, 3)

    def forward(self, x: torch.Tensor, mask_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        dt = self.dtype
        x = x.to(dt)
        if self.input_proj is not None:
            x = self.input_proj(x)
        B, C, H, W = x.shape
        Q = self.num_queries
        src = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        pos = sine_position_embedding_2d(H, W, C // 2, device=x.device,
                                         dtype=dt).reshape(1, H * W, C)
        qpos = cast(self.query_embed.weight, dt)[None].expand(B, Q, C)
        tgt = torch.zeros((B, Q, C), dtype=dt, device=x.device)
        hs = self.transformer.decoder(tgt, src, pos, qpos)  # (L, B, Q, C)
        membed = self.mask_embed(hs)
        masks = torch.einsum("lbqc,bchw->lbqhw", membed, mask_features.to(dt))
        out = {"pred_masks": masks[-1].float(), "aux_masks": masks[:-1].float()}
        if self.mask_classification:
            logits = self.class_embed(hs)
            out["pred_logits"] = logits[-1].float()
            out["aux_logits"] = logits[:-1].float()
        return out


class TransformerEncoderPixelDecoder(BasePixelDecoder):
    """FPN pixel decoder with a transformer encoder at res5 (reference:
    fpn.py:205-312): a 1x1 `input_proj`, post-norm self-attention over the
    res5 tokens with a sine position embedding, then `BasePixelDecoder`'s
    top-down path from the encoder's output. `transformer_enc_layers` 0
    gives 6 layers, as the JAX module's `transformer_enc_layers or 6` does.
    Returns (mask_features, the encoder's output (B, C, H32, W32),
    multi_scale)."""

    def __init__(self, cfg: PixelDecoderConfig, in_channels: Dict[str, int],
                 in_strides: Dict[str, int], dtype: torch.dtype = torch.float32):
        top = sorted(in_strides, key=in_strides.get)[-1]
        # the coarsest output conv reads the encoder's output, conv_dim wide
        super().__init__(cfg, {**in_channels, top: cfg.conv_dim}, in_strides, dtype)
        C = cfg.conv_dim
        self.input_proj = _c2_xavier_conv(in_channels[top], C)
        self.transformer = _EncoderOnly(TransformerEncoder(
            cfg.transformer_enc_layers or 6, C, cfg.transformer_nheads,
            cfg.transformer_dim_feedforward, pre_norm=False))

    def encode_top(self, features: Dict[str, torch.Tensor]):
        tin = self.input_proj(features[self.in_features[-1]].to(self.dtype))
        B, C, H, W = tin.shape
        pos = sine_position_embedding_2d(H, W, C // 2, device=tin.device,
                                         dtype=self.dtype).reshape(1, H * W, C)
        enc = self.transformer.encoder(tin.flatten(2).transpose(1, 2), pos)
        y = enc.transpose(1, 2).reshape(B, C, H, W)
        return y, y


class PerPixelBaselineHead(nn.Module):
    """Per-pixel classification baseline (reference:
    per_pixel_baseline.py:18-126): `BasePixelDecoder`, then a 1x1
    classifier on the mask features. Returns (B, H4, W4, K) f32 logits."""

    def __init__(self, cfg: PixelDecoderConfig, num_classes: int,
                 in_channels: Dict[str, int], in_strides: Dict[str, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_decoder = BasePixelDecoder(cfg, in_channels, in_strides, dtype)
        self.predictor = _c2_xavier_conv(cfg.mask_dim, num_classes)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        mask_features, _, _ = self.pixel_decoder(features)
        return self.predictor(mask_features).float().permute(0, 2, 3, 1)


class PerPixelBaselinePlusHead(nn.Module):
    """Per-pixel baseline + transformer (reference:
    per_pixel_baseline.py:127-243): a `TransformerEncoderPixelDecoder` feeds
    a `StandardTransformerDecoder` without classification whose queries are
    the classes, so each query's mask logits are its class's per-pixel
    scores. Returns the (B, H4, W4, K) logits and, with
    `deep_supervision`, every earlier layer's (L-1, B, H4, W4, K)."""

    def __init__(self, cfg: PixelDecoderConfig, dec_cfg: DecoderConfig, num_classes: int,
                 in_channels: Dict[str, int], in_strides: Dict[str, int],
                 dtype: torch.dtype = torch.float32, deep_supervision: bool = True):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.pixel_decoder = TransformerEncoderPixelDecoder(cfg, in_channels, in_strides,
                                                            dtype)
        self.predictor = StandardTransformerDecoder(
            dec_cfg, num_classes, cfg.conv_dim, dtype, mask_classification=False,
            num_queries=num_classes)

    def forward(self, features: Dict[str, torch.Tensor]):
        mask_features, transformer_feature, _ = self.pixel_decoder(features)
        out = self.predictor(transformer_feature, mask_features)
        logits = out["pred_masks"].permute(0, 2, 3, 1)
        if not self.deep_supervision:
            return logits
        return logits, out["aux_masks"].permute(0, 1, 3, 4, 2)
