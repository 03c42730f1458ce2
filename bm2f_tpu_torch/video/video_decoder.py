"""Video masked transformer decoder (reference:
mask2former_video/modeling/transformer_decoder/video_mask2former_transformer_decoder.py:380-460),
as the JAX package computes it (bm2f_tpu/video/video_decoder.py): the image
decoder with a clip-wide memory.

- Each level's keys are the clip's T*H*W tokens (order t, h, w), with the
  3D sine embedding (the temporal term added across the full width).
- The attention mask of the next layer is einsum(mask_embed,
  resize(mask_features)) per level, flattened over (t, h, w), as in the
  image decoder; masks come out as (B, Q, T, h4, w4).
- With `frame_valid` (B, T), the padded frames' keys are blocked in every
  cross-attention and the temporal embedding is normalized over the real
  frames only; a query that would block every key falls back to the valid
  keys, never to the padding. Without it, such a query attends to every
  key, as in the image decoder.

The parameters are the image decoder's under the same names, so one
`state_dict` fits both. The JAX package's two layouts (a scanned `rounds`
module when `dec_layers` is a multiple of the level count, else unrolled
`cross_attn_{i}` modules) compute the same layers in the same order; the
weight converter maps both onto these names.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from bm2f_tpu_torch.models.layers import cast
from bm2f_tpu_torch.models.position_encoding import (
    sine_position_embedding_3d,
    sine_position_embedding_3d_masked,
)
from bm2f_tpu_torch.models.transformer_decoder import (
    NEG_INF,
    MultiScaleMaskedTransformerDecoder,
)
from bm2f_tpu_torch.ops import resize_bilinear


class VideoMultiScaleMaskedTransformerDecoder(MultiScaleMaskedTransformerDecoder):
    """forward(x, mask_features, frame_valid=None):
      x: list of 3 features [(B, T, C, H, W)] (stride 32, 16, 8)
      mask_features: (B, T, mask_dim, h4, w4)
      frame_valid: optional (B, T) bool, False on padded frames
    returns pred_logits (B, Q, K+1), pred_masks (B, Q, T, h4, w4) and the
    stacked aux_logits (L, B, Q, K+1), aux_masks (L, B, Q, T, h4, w4)."""

    def forward(self, x: Sequence[torch.Tensor], mask_features: torch.Tensor,
                frame_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        C, nL, Q = cfg.hidden_dim, cfg.num_feature_levels, cfg.num_queries
        assert len(x) == nL
        B, T, dt = x[0].shape[0], x[0].shape[1], self.dtype
        mask_features = mask_features.to(dt)

        srcs, poss, mf_lvl, hw = [], [], [], []
        for i in range(nL):
            feat = self.input_proj[i](x[i].flatten(0, 1).to(dt))  # (B*T, C, H, W)
            H, W = feat.shape[-2:]
            hw.append(H * W)
            feat = feat.reshape(B, T, C, H * W).permute(0, 1, 3, 2).reshape(B, T * H * W, C)
            srcs.append(feat + cast(self.level_embed.weight, dt)[i])
            if frame_valid is None:
                pe = sine_position_embedding_3d(T, H, W, C // 2, device=feat.device,
                                                dtype=dt).reshape(1, T * H * W, C)
            else:
                pe = sine_position_embedding_3d_masked(frame_valid, H, W, C // 2,
                                                       dtype=dt).reshape(B, T * H * W, C)
            poss.append(pe)
            # mask features resized ONCE per attention resolution, (B, Cm, T*H*W)
            mf = resize_bilinear(mask_features, H, W)  # (B, T, Cm, H, W)
            mf_lvl.append(mf.permute(0, 2, 1, 3, 4).flatten(2))

        invalid = None if frame_valid is None else [
            (~frame_valid).repeat_interleave(n, dim=1)[:, None] for n in hw]  # (B, 1, T*H*W)

        def head(output, lvl):
            """decoder_norm -> mask_embed -> next layer's attention bias:
            block where sigmoid < 0.5 and on padded frames; a row that
            blocks every key falls back to the valid keys (every key
            without `frame_valid`)."""
            dec = self.decoder_norm(output)
            membed = self.mask_embed(dec)
            am = torch.einsum("bqc,bcn->bqn", membed, mf_lvl[lvl])
            blocked = torch.sigmoid(am.float()) < 0.5
            if invalid is None:
                blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
            else:
                blocked = blocked | invalid[lvl]
                blocked = torch.where(blocked.all(dim=-1, keepdim=True),
                                      invalid[lvl], blocked)
            bias = torch.zeros(blocked.shape, dtype=output.dtype, device=output.device)
            bias = bias.masked_fill(blocked, NEG_INF)[:, None]  # (B, 1, Q, T*H*W)
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
        all_masks = torch.einsum("lbqc,btchw->lbqthw", torch.stack(membeds), mask_features)
        return {
            "pred_logits": all_logits[-1].float(),
            "pred_masks": all_masks[-1].float(),
            "aux_logits": all_logits[:-1].float(),
            "aux_masks": all_masks[:-1].float(),
        }
