"""Vanilla DETR transformer (reference:
mask2former/modeling/transformer_decoder/transformer.py:19-369), as the JAX
package computes it (bm2f_tpu/models/transformer.py): encoder and decoder
layers in pre- or post-norm, batch-first (B, N, C), used by the
MaskFormer-v1 `StandardTransformerDecoder` and
`TransformerEncoderPixelDecoder` (`models/maskformer_v1.py`).

Parameter names follow upstream MaskFormer (`layers.{i}.self_attn`,
`multihead_attn`, `linear1`, `linear2`, `norm1`-`norm3`, and the stack's
`norm`); attention is `models/layers.py` `MultiHeadAttention`, torch's
packed `in_proj_weight` layout. Weights start xavier-uniform, biases zero,
as the JAX modules' (`init_parameters`' default rule).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from bm2f_tpu_torch.models.layers import LayerNorm, Linear, MultiHeadAttention
from bm2f_tpu_torch.parallel import tp as tparallel


class TransformerEncoderLayer(tparallel.ParallelFFN, nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 pre_norm: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.pre_norm = pre_norm

    def forward(self, src, pos):
        if self.pre_norm:
            s = self.norm1(src)
            src = src + self.self_attn(s + pos, s + pos, s)
            return src + self.ffn(self.norm2(src))
        src = self.norm1(src + self.self_attn(src + pos, src + pos, src))
        return self.norm2(src + self.ffn(src))


class TransformerDecoderLayer(tparallel.ParallelFFN, nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 pre_norm: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.pre_norm = pre_norm

    def forward(self, tgt, memory, pos, query_pos):
        if self.pre_norm:
            t = self.norm1(tgt)
            tgt = tgt + self.self_attn(t + query_pos, t + query_pos, t)
            t = self.norm2(tgt)
            tgt = tgt + self.multihead_attn(t + query_pos, memory + pos, memory)
            return tgt + self.ffn(self.norm3(tgt))
        tgt = self.norm1(tgt + self.self_attn(tgt + query_pos, tgt + query_pos, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.ffn(tgt))


class TransformerEncoder(nn.Module):
    """`num_layers` encoder layers; the final `norm` exists only with
    `pre_norm` (reference transformer.py:46-51)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 2048, pre_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, pre_norm)
            for _ in range(num_layers))
        self.norm: Optional[nn.Module] = LayerNorm(d_model, eps=1e-5) if pre_norm else None

    def forward(self, src, pos):
        for layer in self.layers:
            src = layer(src, pos)
        return self.norm(src) if self.norm is not None else src


class TransformerDecoder(nn.Module):
    """Every layer's output through the one shared final `norm`, stacked
    (num_layers, B, Q, C) for deep supervision (reference
    TransformerDecoder with return_intermediate)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 2048, pre_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, pre_norm)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos) -> torch.Tensor:
        outs = []
        for layer in self.layers:
            tgt = layer(tgt, memory, pos, query_pos)
            outs.append(self.norm(tgt))
        return torch.stack(outs)
