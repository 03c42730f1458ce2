"""Mask2Former masked transformer decoder (reference:
mask2former/modeling/transformer_decoder/mask2former_transformer_decoder.py:207-465).

- batch-first (B, Q, C) throughout;
- the boolean attention mask is an additive bias (NEG_INF where blocked);
- queries whose predicted mask blocks every position attend everywhere
  (reference :400);
- the attention mask is einsum(mask_embed, resize(mask_features)), with the
  mask features resized once per level: bilinear resize commutes with the
  channel contraction, so this equals the reference's resize(einsum);
- per-layer predictions are stacked: aux outputs are (L, B, ...);
- `dtype` is the compute dtype: features, mask features, embeddings and
  queries are cast to it, the attention mask is taken from a sigmoid in
  f32, and the outputs are f32 (as the JAX package's).

Parameter names follow detectron2 (`transformer_cross_attention_layers.{i}
.multihead_attn`, `transformer_self_attention_layers.{i}.self_attn`,
`transformer_ffn_layers.{i}`, `query_feat`, `query_embed`, `level_embed`,
`decoder_norm`, `class_embed`, `mask_embed.layers.{j}`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from bm2f_tpu_torch.config import DecoderConfig
from bm2f_tpu_torch.models.layers import MLP, Conv2d, LayerNorm, Linear, MultiHeadAttention, cast
from bm2f_tpu_torch.models.position_encoding import sine_position_embedding_2d
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.parallel import tp as tparallel

NEG_INF = -1e9  # finite -inf surrogate: keeps softmax well-defined


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.pre_norm = pre_norm

    def forward(self, tgt, query_pos):
        if self.pre_norm:
            t = self.norm(tgt)
            q = t + query_pos
            return tgt + self.self_attn(q, q, t)
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.pre_norm = pre_norm

    def forward(self, tgt, memory, attn_bias, pos, query_pos):
        if self.pre_norm:
            t = self.norm(tgt)
            return tgt + self.multihead_attn(t + query_pos, memory + pos,
                                             memory, attn_bias)
        return self.norm(tgt + self.multihead_attn(
            tgt + query_pos, memory + pos, memory, attn_bias))


class FFNLayer(tparallel.ParallelFFN, nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, pre_norm: bool = False):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.pre_norm = pre_norm

    def forward(self, tgt):
        if self.pre_norm:
            return tgt + self.ffn(self.norm(tgt))
        return self.norm(tgt + self.ffn(tgt))


class MultiScaleMaskedTransformerDecoder(nn.Module):
    """Masked-attention decoder over 3 feature scales.

    forward(x, mask_features):
      x: list of 3 features [(B,C,H32,W32), (B,C,H16,W16), (B,C,H8,W8)]
      mask_features: (B, mask_dim, H4, W4)
    returns dict:
      pred_logits: (B, Q, K+1)          — final layer
      pred_masks:  (B, Q, H4, W4)
      aux_logits:  (Ldec, B, Q, K+1)    — layers 0..L-1 (layer 0 = raw queries)
      aux_masks:   (Ldec, B, Q, H4, W4)
    """

    def __init__(self, cfg: DecoderConfig, num_classes: int,
                 in_channels: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        C, nL = cfg.hidden_dim, cfg.num_feature_levels
        self.query_feat = nn.Embedding(cfg.num_queries, C)
        self.query_embed = nn.Embedding(cfg.num_queries, C)
        self.level_embed = nn.Embedding(nL, C)
        self.input_proj = nn.ModuleList(
            Conv2d(ci, C, 1) if (ci != C or cfg.enforce_input_project)
            else nn.Identity()
            for ci in in_channels)
        L = cfg.dec_layers
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, cfg.nheads, cfg.pre_norm) for _ in range(L))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, cfg.nheads, cfg.pre_norm) for _ in range(L))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, cfg.dim_feedforward, cfg.pre_norm) for _ in range(L))
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.class_embed = Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, cfg.mask_dim, 3)

    def forward(self, x: Sequence[torch.Tensor],
                mask_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        C, nL, Q = cfg.hidden_dim, cfg.num_feature_levels, cfg.num_queries
        assert len(x) == nL
        B, dt = x[0].shape[0], self.dtype
        mask_features = mask_features.to(dt)

        srcs, poss, mf_lvl = [], [], []
        for i in range(nL):
            feat = self.input_proj[i](x[i].to(dt))
            H, W = feat.shape[-2:]
            srcs.append(feat.flatten(2).transpose(1, 2) + cast(self.level_embed.weight, dt)[i])
            pe = sine_position_embedding_2d(H, W, C // 2, device=feat.device,
                                            dtype=feat.dtype)
            poss.append(pe.reshape(1, H * W, C))
            # mask features resized ONCE per attention resolution
            mf_lvl.append(resize_bilinear(mask_features, H, W).flatten(2))

        def head(output, lvl):
            """decoder_norm -> mask_embed -> next layer's attention bias
            (reference :437-452): block where sigmoid < 0.5, unblock rows
            that would block every position."""
            dec = self.decoder_norm(output)
            membed = self.mask_embed(dec)
            am = torch.einsum("bqc,bcn->bqn", membed, mf_lvl[lvl])
            blocked = torch.sigmoid(am.float()) < 0.5
            blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
            bias = torch.zeros(blocked.shape, dtype=output.dtype,
                               device=output.device)
            bias = bias.masked_fill(blocked, NEG_INF)[:, None]  # (B,1,Q,HW)
            return dec, membed, bias

        output = cast(self.query_feat.weight, dt)[None].expand(B, Q, C)
        qpos = cast(self.query_embed.weight, dt)[None].expand(B, Q, C)
        dec, membed, bias = head(output, 0)  # layer-0 prediction: raw queries
        decs: List[torch.Tensor] = [dec]
        membeds: List[torch.Tensor] = [membed]
        for i in range(cfg.dec_layers):
            li = i % nL
            output = self.transformer_cross_attention_layers[i](
                output, srcs[li], bias, poss[li], qpos)
            output = self.transformer_self_attention_layers[i](output, qpos)
            output = self.transformer_ffn_layers[i](output)
            dec, membed, bias = head(output, (i + 1) % nL)
            decs.append(dec)
            membeds.append(membed)

        all_logits = self.class_embed(torch.stack(decs))  # (L+1, B, Q, K+1)
        all_masks = torch.einsum("lbqc,bchw->lbqhw", torch.stack(membeds),
                                 mask_features)
        return {
            "pred_logits": all_logits[-1].float(),
            "pred_masks": all_masks[-1].float(),
            "aux_logits": all_logits[:-1].float(),
            "aux_masks": all_masks[:-1].float(),
        }
