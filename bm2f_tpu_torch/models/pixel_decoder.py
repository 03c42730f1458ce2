"""MSDeformAttn pixel decoder — the default pixel decoder of Mask2Former
(reference: mask2former/modeling/pixel_decoder/msdeformattn.py:165-358) —
and MaskFormer-v1's FPN `BasePixelDecoder` (fpn.py:38-204).

- NCHW feature maps, batch-first (B, S, C) sequences;
- the deformable-attention core is `bm2f_tpu_torch.ops.ms_deform_attn`
  (the hand-written CUDA kernel on the card, the plain version on the CPU);
- no padding masks: the reference feeds an all-False mask
  (msdeformattn.py:62), so valid ratios are 1 and the reference points
  depend only on the level sizes;
- `dtype` is the compute dtype (f32, or bf16 when the model's is and
  `pixel_decoder_f32` is off). In bf16 the deformable module follows the
  JAX package's Pallas path, the counterpart of the kernel: the attention
  softmax and the sampling locations stay f32, the kernel reads the bf16
  `value` and returns f32, and `output_proj` casts it back.

Module and parameter names follow detectron2
(`input_proj.{i}.{0,1}`, `transformer.level_embed`,
`transformer.encoder.layers.{i}.self_attn.value_proj`, `adapter_1`,
`layer_1`, `mask_features`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bm2f_tpu_torch.config import PixelDecoderConfig
from bm2f_tpu_torch.models.layers import (
    Conv2d,
    GroupNorm,
    LayerNorm,
    Linear,
    cast,
    device_constant,
    get_norm,
)
from bm2f_tpu_torch.models.position_encoding import sine_position_embedding_2d
from bm2f_tpu_torch.ops import ms_deform_attn, resize_bilinear, resize_nearest
from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_plain
from bm2f_tpu_torch.parallel import tp as tparallel

Shapes = Tuple[Tuple[int, int], ...]


def _offset_bias_ring_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Ring init of sampling-offset biases (reference:
    ops/modules/ms_deform_attn.py:66-74): head h points at angle
    2*pi*h/n_heads, normalized to unit Linf, scaled by point index.
    Flat (M*L*P*2,)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (M, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnModule(nn.Module):
    """Deformable attention module (reference:
    ops/modules/ms_deform_attn.py:34-125). query/value_src are (B, N, C).
    Under tensor parallelism (`tp`, see `parallel.tp`) it runs the rank's
    M/T heads: `value_proj` column-parallel, the replicated
    `sampling_offsets` and `attention_weights` read at the rank's heads'
    rows, the deformable core on M/T heads, `output_proj` row-parallel."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)
        self.tp = None

    def tp_splits(self, size: int):
        return tparallel.head_splits(
            size, self.n_heads, {"value_proj.weight": tparallel.COLUMN,
                                 "value_proj.bias": tparallel.COLUMN},
            ("output_proj.weight",))

    def tp_departures(self, size: int):
        return tparallel.head_departures(size, self.n_heads, self.value_proj.in_features,
                                         ("value_proj.weight", "value_proj.bias"),
                                         ("output_proj.weight",))

    def _head_linear(self, linear: Linear, x):
        """`linear(x)` at this rank's heads' rows (all of them without `tp`)."""
        if self.tp is None:
            return linear(x)
        w = tparallel.head_slice(linear.weight, self.tp, 0, self.n_heads)
        b = tparallel.head_slice(linear.bias, self.tp, 0, self.n_heads)
        return F.linear(x, cast(w, x.dtype), cast(b, x.dtype))

    def ring_bias(self) -> torch.Tensor:
        """The from-scratch value of `sampling_offsets.bias`."""
        return torch.from_numpy(_offset_bias_ring_init(
            self.n_heads, self.n_levels, self.n_points))

    def forward(self, query, reference_points, value_src, spatial_shapes: Shapes,
                deform_impl: str = "auto"):
        """reference_points: (Q, L, 2) in [0, 1] (x, y), batch-independent.
        deform_impl: "auto" dispatches on the device (kernel on the card);
        "plain" forces the plain PyTorch version (parity checks only)."""
        B, Q, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        D = C // M
        if self.tp is not None:
            query, value_src = tparallel.copy_inputs(self.tp, query, value_src)
            M //= self.tp.size
        value = self.value_proj(value_src).view(B, -1, M, D)
        offsets = self._head_linear(self.sampling_offsets, query).view(B, Q, M, L, P, 2)
        attn = self._head_linear(self.attention_weights, query).view(B, Q, M, L * P)
        attn = torch.softmax(attn.float(), dim=-1).view(B, Q, M, L, P)  # f32
        # per-level normalizer (W, H) (reference ms_deform_attn.py:107-109)
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        normalizer = device_constant(("wh", shapes), lambda: [[w, h] for h, w in shapes],
                                     query.device, torch.float32)
        loc = (reference_points[None, :, None, :, None, :]
               + offsets.float() / normalizer[None, None, None, :, None, :])
        if deform_impl == "plain":
            out = ms_deform_attn_plain(value, spatial_shapes, loc, attn)
        elif deform_impl == "auto":
            out = ms_deform_attn(value, spatial_shapes, loc, attn)
        else:
            raise ValueError(f"unknown deform_impl {deform_impl!r}")
        out = out.to(value.dtype)  # the core returns f32
        if self.tp is not None:
            return tparallel.row_linear(self.output_proj, out, self.tp)
        return self.output_proj(out)


class DeformableEncoderLayer(tparallel.ParallelFFN, nn.Module):
    """Post-norm deformable encoder layer (reference: msdeformattn.py:92-131)."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes: Shapes,
                deform_impl: str = "auto"):
        src = self.norm1(src + self.self_attn(
            src + pos, reference_points, src, spatial_shapes, deform_impl))
        return self.norm2(src + self.ffn(src))


@functools.lru_cache(maxsize=16)
def _reference_points(spatial_shapes: Shapes) -> np.ndarray:
    refs = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float64) + 0.5) / h
        xs = (np.arange(w, dtype=np.float64) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        refs.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(refs, 0).astype(np.float32)  # (S, 2)
    out = np.ascontiguousarray(np.tile(ref[:, None, :], (1, len(spatial_shapes), 1)))
    out.setflags(write=False)
    return out


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             device="cpu") -> torch.Tensor:
    """Reference grid (reference: msdeformattn.py:141-153 with valid_ratios
    == 1): pixel centres normalized per level, broadcast to all sampling
    levels. Returns (S, L, 2) (x, y)."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return device_constant(("reference_points", shapes), lambda: _reference_points(shapes),
                           device, torch.float32)


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(**layer_kw) for _ in range(n_layers))


class MSDeformAttnTransformerEncoderOnly(nn.Module):
    """Holds `level_embed` and `encoder.layers.{i}` under detectron2's
    names (reference: msdeformattn.py:24-89)."""

    def __init__(self, d_model: int, n_levels: int, n_layers: int, **layer_kw):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model))
        self.encoder = _Encoder(n_layers, d_model=d_model, n_levels=n_levels,
                                **layer_kw)


class MSDeformAttnPixelDecoder(nn.Module):
    """Features arrive as {res2..res5: (B, C, H, W)}. Returns
    (mask_features, encoder_top_feature, multi_scale_features) where
    multi_scale_features = [stride32, stride16, stride8] and mask_features
    is at stride `common_stride` (4)."""

    def __init__(self, cfg: PixelDecoderConfig, in_channels: Dict[str, int],
                 in_strides: Dict[str, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        C = cfg.conv_dim
        # transformer levels, top-down order (res5, res4, res3)
        self.tr_feats = sorted(cfg.transformer_in_features,
                               key=lambda f: in_strides[f], reverse=True)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(in_channels[f], C, 1), GroupNorm(32, C, eps=1e-5))
            for f in self.tr_feats)
        self.transformer = MSDeformAttnTransformerEncoderOnly(
            C, len(self.tr_feats), cfg.transformer_enc_layers,
            d_ffn=cfg.transformer_dim_feedforward, n_heads=cfg.transformer_nheads,
            n_points=cfg.transformer_n_points)
        # extra FPN levels down to common_stride, highest resolution first
        # (detectron2 names them adapter_1, layer_1, ...)
        self.fpn_feats = [
            f for f in sorted(in_strides, key=in_strides.get)
            if f not in cfg.transformer_in_features
            and in_strides[f] >= cfg.common_stride
        ]
        use_bias = cfg.norm in ("", None, "none")
        for k, f in enumerate(self.fpn_feats, start=1):
            self.add_module(f"adapter_{k}", Conv2d(
                in_channels[f], C, 1, bias=use_bias, norm=get_norm(cfg.norm, C)))
            self.add_module(f"layer_{k}", Conv2d(
                C, C, 3, padding=1, bias=use_bias, norm=get_norm(cfg.norm, C)))
        self.mask_features = Conv2d(C, cfg.mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor], deform_impl: str = "auto"):
        C = self.cfg.conv_dim
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(self.tr_feats):
            x = self.input_proj[i](features[f].to(self.dtype))
            B, _, H, W = x.shape
            shapes.append((H, W))
            srcs.append(x.flatten(2).transpose(1, 2))  # (B, HW, C)
            pe = sine_position_embedding_2d(H, W, C // 2, device=x.device,
                                            dtype=x.dtype)
            poss.append(pe.reshape(H * W, C) + cast(self.transformer.level_embed, x.dtype)[i])
        shapes = tuple(shapes)
        src = torch.cat(srcs, 1)
        pos = torch.cat(poss, 0)[None]  # (1, S, C)
        ref = encoder_reference_points(shapes, device=src.device)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, shapes, deform_impl)

        # split back to images, top-down order (res5 first)
        out: List[torch.Tensor] = []
        start = 0
        for (H, W) in shapes:
            out.append(src[:, start:start + H * W].transpose(1, 2)
                       .reshape(B, C, H, W))
            start += H * W

        # FPN fuse, bilinear top-down (reference msdeformattn.py:343-351)
        for k in range(len(self.fpn_feats), 0, -1):
            lat = getattr(self, f"adapter_{k}")(features[self.fpn_feats[k - 1]].to(self.dtype))
            y = lat + resize_bilinear(out[-1], lat.shape[-2], lat.shape[-1])
            out.append(F.relu(getattr(self, f"layer_{k}")(y)))

        mask_features = self.mask_features(out[-1])
        return mask_features, out[0], out[:3]


class BasePixelDecoder(nn.Module):
    """Vanilla FPN pixel decoder (reference: fpn.py:38-204), as the JAX
    package's `BasePixelDecoder` computes it: from res5 down to res2, a 3x3
    output conv on the coarsest feature, then at each finer level a 1x1
    lateral conv plus the **nearest**-resized coarser output, through a 3x3
    output conv; every conv is followed by GroupNorm(32) (a bias only when
    `cfg.norm` is empty) and each output by a ReLU. A **3x3** conv gives the
    mask features (msdeform's is 1x1). Returns (mask_features, None,
    multi_scale) with multi_scale the three coarsest outputs, coarsest
    first. It has no deformable attention: `deform_impl` is accepted, as
    every pixel decoder's forward takes it, and has nothing to choose.

    Names follow upstream: `layer_{k}` and `adapter_{k}` with k = 1 at res2
    (the JAX package counts from res5: its `layer_0` is `layer_4` here)."""

    def __init__(self, cfg: PixelDecoderConfig, in_channels: Dict[str, int],
                 in_strides: Dict[str, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        C = cfg.conv_dim
        self.in_features = sorted(in_strides, key=in_strides.get)  # res2..res5
        n = len(self.in_features)
        use_bias = cfg.norm in ("", None, "none")
        for k, f in enumerate(self.in_features, start=1):
            if k < n:
                self.add_module(f"adapter_{k}", Conv2d(
                    in_channels[f], C, 1, bias=use_bias, norm=GroupNorm(32, C, eps=1e-5)))
            self.add_module(f"layer_{k}", Conv2d(
                C if k < n else in_channels[f], C, 3, padding=1, bias=use_bias,
                norm=GroupNorm(32, C, eps=1e-5)))
        self.mask_features = Conv2d(C, cfg.mask_dim, 3, padding=1)

    def encode_top(self, features: Dict[str, torch.Tensor]):
        """(the input of the coarsest output conv, the transformer feature)."""
        return features[self.in_features[-1]].to(self.dtype), None

    def forward(self, features: Dict[str, torch.Tensor], deform_impl: str = "auto"):
        n = len(self.in_features)
        top, transformer_feature = self.encode_top(features)
        y = F.relu(getattr(self, f"layer_{n}")(top))
        out = [y]
        for k in range(n - 1, 0, -1):
            lat = getattr(self, f"adapter_{k}")(features[self.in_features[k - 1]].to(self.dtype))
            y = lat + resize_nearest(y, lat.shape[-2], lat.shape[-1])
            y = F.relu(getattr(self, f"layer_{k}")(y))
            out.append(y)
        return self.mask_features(y), transformer_feature, out[:3]
