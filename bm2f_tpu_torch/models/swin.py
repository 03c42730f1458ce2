"""Swin Transformer backbone (reference: mask2former/modeling/backbone/swin.py,
a detectron2 wrap of the official Swin), as the JAX package computes it
(bm2f_tpu/models/swin.py), in PyTorch.

- Takes NCHW like the port's other backbones and returns contiguous NCHW
  `res2`-`res5`; computes NHWC inside (every Linear acts on the last axis).
- Window order is batch-major (B, then H/w, then W/w), and the shift mask
  adds per window as (B, nW, heads, N, N) + mask[None, :, None].
- The shift mask is built on the input's device from zone ids (the JAX
  package's `_shift_attn_mask_device`) and cached per shape, device and
  dtype; the relative-position index is a non-persistent buffer, so neither
  is part of `state_dict()` (the JAX tree has no such leaf).
- Attention is plain batched products and an f32 softmax, as in JAX (an
  f64 model, the card's reference, stays in f64 throughout).
- DropPath is active only when the backbone is called with
  `deterministic=False`. `MaskFormer` never does, as the JAX `MaskFormer`
  never does, so training runs without stochastic depth (ROADMAP §3).
- `use_checkpoint` recomputes each block in the backward
  (`torch.utils.checkpoint`, the JAX package's `nn.remat`).
- `ape` resizes the absolute position table bilinearly (`ops.resize_bilinear`,
  as JAX does; upstream used bicubic).
- Traced (`utils.tracing`): each `WindowAttention.forward` opens the span
  "swin.window_attn" over its core, from q, k, v to the output before
  `proj` (scores, bias, mask, softmax, the product with v), and adds to the
  counters "swin.attn_flops" (4 windows N^2 C: the two products over the
  padded windows) and "swin.attn_bytes" (4 windows N C at the input's
  element size: q, k, v read and the output written once), Python ints
  from the shapes. Off, a call costs one check.

Parameter names are upstream's: `patch_embed.{proj,norm}`, `absolute_pos_embed`
(1, C, gs, gs), `layers.{s}.blocks.{i}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}`,
`layers.{s}.downsample.{norm,reduction}` and `norm{s}`.

Variants (reference config.py:74-90): T (96, [2,2,6,2], [3,6,12,24], w7),
S (96, [2,2,18,2]), B (128, [2,2,18,2], [4,8,16,32]), L (192, [2,2,18,2],
[6,12,24,48], w7 or w12 for 384 pretrain).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from bm2f_tpu_torch.config import SwinConfig
from bm2f_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, at_least_f32, cast
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.utils import tracing


def relative_position_index(window: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 bias table (standard Swin)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def shift_attn_mask(hp: int, wp: int, window: int, shift: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive mask (nW, w*w, w*w), -100 between tokens of different
    pre-shift zones. A zone id per row and column is 0 on [0, n-w), 1 on
    [n-w, n-shift) and 2 on the last `shift`; the region id is 3 row + col,
    which orders the regions as the reference's counter does. Built in the
    memory pool of kept tables (`utils.memory.kept_allocations`)."""
    from bm2f_tpu_torch.utils.memory import kept_allocations

    def zone(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    with kept_allocations(device):
        ids = zone(hp)[:, None] * 3 + zone(wp)[None, :]
        win = ids.reshape(hp // window, window, wp // window, window)
        win = win.permute(0, 2, 1, 3).reshape(-1, window * window)
        diff = win[:, :, None] != win[:, None, :]
        return torch.where(diff, -100.0, 0.0).to(dtype)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C); H, W divisible by window."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(x: torch.Tensor, window: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class DropPath(nn.Module):
    """Stochastic depth, applied only when called with deterministic=False."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, deterministic: bool = True):
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)).reshape(-1),
                             persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.tp = None

    def _packed(self):
        return ("qkv.weight", "qkv.bias") if self.qkv.bias is not None else ("qkv.weight",)

    def tp_splits(self, size: int):
        return tparallel.head_splits(size, self.num_heads,
                                     dict.fromkeys(self._packed(), tparallel.PACKED),
                                     ("proj.weight",))

    def tp_departures(self, size: int):
        C = self.proj.in_features
        return tparallel.head_departures(size, self.num_heads, C, self._packed(),
                                         ("proj.weight",), 3 * C)

    def forward(self, x, attn_mask=None):
        """x: (nW*B, N, C) with N = window^2; attn_mask (nW, N, N) or None.
        Under tensor parallelism (`tp`, see `parallel.tp`) the rank's heads:
        `qkv` column-parallel by head, the bias table's columns of those
        heads, `proj` row-parallel."""
        Bw, N, C = x.shape
        H = self.num_heads
        D = C // H
        table = self.relative_position_bias_table
        if self.tp is not None:
            x = tparallel.copy_to_model(x, self.tp)
            table = tparallel.head_slice(table, self.tp, 1, H)
            H //= self.tp.size
        q, k, v = self.qkv(x).reshape(Bw, N, 3, H, D).permute(2, 0, 3, 1, 4)
        core = tracing.span("swin.window_attn")
        with core:
            if core is not tracing.NULL:
                # the padded windows' work: q k^T and attn v; q, k, v read, the output written
                tracing.count("swin.attn_flops", 4 * Bw * N * N * H * D)
                tracing.count("swin.attn_bytes", 4 * Bw * N * H * D * x.element_size())
            attn = (q * self.scale) @ k.transpose(-2, -1)
            table = cast(table, x.dtype)
            bias = table[self.relative_position_index].reshape(N, N, H).permute(2, 0, 1)
            attn = attn + bias[None]
            if attn_mask is not None:
                nW = attn_mask.shape[0]
                attn = (attn.reshape(Bw // nW, nW, H, N, N) + attn_mask[None, :, None]
                        ).reshape(Bw, H, N, N)
            attn = torch.softmax(at_least_f32(attn), dim=-1).to(x.dtype)
            out = (attn @ v).transpose(1, 2).reshape(Bw, N, H * D)
        if self.tp is not None:
            return tparallel.row_linear(self.proj, out, self.tp)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.tp = None

    def tp_splits(self, size: int):
        return tparallel.ffn_splits("fc1", "fc2", self.fc1.out_features, size)

    def forward(self, x):
        return tparallel.ffn(x, self.fc1, self.fc2, F.gelu, self.tp)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads, qkv_bias, qk_scale)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, deterministic: bool = True):
        """x: (B, H, W, C)."""
        B, H, W, C = x.shape
        w, shift = self.window, self.shift
        shortcut = x
        x = self.norm1(x)
        hp, wp = math.ceil(H / w) * w, math.ceil(W / w) * w
        x = F.pad(x, (0, 0, 0, wp - W, 0, hp - H))
        # the reference rolls whenever shift > 0, even when the padded map is
        # a single window, and relies on the region mask
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = shift_attn_mask(hp, wp, w, shift, x.device, x.dtype)
        x = window_reverse(self.attn(window_partition(x, w), mask), w, B, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = shortcut + self.drop_path(x[:, :H, :W], deterministic)
        return x + self.drop_path(self.mlp(self.norm2(x)), deterministic)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.tp = None

    def tp_splits(self, size: int):
        n = self.reduction.in_features
        return {"reduction.weight": tparallel.ROW} if size > 1 and n % size == 0 else {}

    def forward(self, x):
        """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C). Under tensor
        parallelism (`tp`, see `parallel.tp`) `reduction` is row-parallel
        over the rank's share of the 4C normalised features, read through
        f (Megatron's scatter of a replicated input)."""
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        x = self.norm(x)
        if self.tp is not None:
            n = x.shape[-1] // self.tp.size
            x = tparallel.copy_to_model(x, self.tp).narrow(-1, self.tp.rank * n, n)
            return tparallel.row_linear(self.reduction, x, self.tp)
        return self.reduction(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x):
        """(B, 3, H, W) -> (B, H/p, W/p, C), padded right/bottom to p."""
        p = self.patch_size
        H, W = x.shape[2:]
        x = self.proj(F.pad(x, (0, (-W) % p, 0, (-H) % p))).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    # `layers.init_parameters`: Linear and conv weights U(+-1/sqrt(fan_in)),
    # as the JAX package's `torch_linear_init`
    torch_linear_init = True

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.3,
                 ape: bool = False, patch_norm: bool = True, pretrain_img_size: int = 224,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_features = tuple(out_features)
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(patch_size, embed_dim, patch_norm)
        if ape:
            gs = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, gs, gs))
        else:
            self.absolute_pos_embed = None
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stages, dim, di = [], embed_dim, 0
        for s, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[s], window, 0 if b % 2 == 0 else window // 2,
                                mlp_ratio, qkv_bias, qk_scale, dpr[di + b])
                      for b in range(depth)]
            di += depth
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim)))
            if f"res{s + 2}" in self.out_features:
                self.add_module(f"norm{s}", LayerNorm(dim, eps=1e-5))
            dim *= 2
        self.layers = nn.ModuleList(stages)

    @classmethod
    def from_config(cls, cfg: SwinConfig, dtype: torch.dtype = torch.float32):
        return cls(embed_dim=cfg.embed_dim, depths=tuple(cfg.depths),
                   num_heads=tuple(cfg.num_heads), window=cfg.window_size,
                   patch_size=cfg.patch_size, mlp_ratio=cfg.mlp_ratio,
                   qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
                   drop_path_rate=cfg.drop_path_rate, ape=cfg.ape,
                   patch_norm=cfg.patch_norm, pretrain_img_size=cfg.pretrain_img_size,
                   out_features=tuple(cfg.out_features),
                   use_checkpoint=cfg.use_checkpoint, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) -> {res2..res5: (B, C_s, ceil(H/4/2^s), ...)} in dtype."""
        x = self.patch_embed(x.to(self.dtype))
        if self.absolute_pos_embed is not None:
            ape = resize_bilinear(self.absolute_pos_embed, x.shape[1], x.shape[2])
            x = x + ape.permute(0, 2, 3, 1).to(self.dtype)
        outs = {}
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                if self.use_checkpoint and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(blk, x, deterministic,
                                                          use_reentrant=False)
                else:
                    x = blk(x, deterministic)
            name = f"res{s + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2).contiguous()
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


SWIN_VARIANTS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}
