"""Mask2Former in plain PyTorch, as the paper and facebookresearch/Mask2Former
describe it (Cheng et al., "Masked-attention Mask Transformer for Universal
Image Segmentation", CVPR 2022):

- the backbone the configuration names (`arch.backbone`), from its file
  under `backbones/`;
- the multi-scale deformable-attention pixel decoder (msdeformattn.py): 1x1
  projections with GroupNorm(32) of res5, res4, res3, sine positions plus a
  level embedding, post-norm encoder layers whose sampling core is
  upstream's `ms_deform_attn_core_pytorch` (`F.grid_sample`, zero padding,
  align_corners=False), then the FPN level of res2 (bilinear top-down) and
  the 1x1 mask-feature convolution;
- the masked-attention decoder (mask2former_transformer_decoder.py):
  cross-attention masked where the previous prediction, resized bilinearly
  to the level, has sigmoid < 0.5 (a row blocked everywhere attends
  everywhere), then self-attention, then the FFN, post-norm, over the levels
  in turn; a prediction head before the first layer and after each.

It is a function of a flat dict of weights named as detectron2 names them
(`backbone...` as its file names them, `sem_seg_head.pixel_decoder...`,
`sem_seg_head.predictor...`), so that the benchmark hands one dict to this
reference and to the system under test. `param_specs` lists those names
with their shapes and the kind of each, which the benchmark's seeded
weights follow.

Departure from upstream, kept because the configuration states it:
padding masks are all-valid (upstream feeds an all-False mask to the
encoder as well), so valid ratios are 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import backbones

NEG_INF = float("-inf")
# the backbone of an `arch` that names none; its sizes then sit in `arch` itself
DEFAULT_BACKBONE = "resnet"


@dataclass(frozen=True)
class Arch:
    """The sizes of one Mask2Former model (defaults: the published
    maskformer2_R50_bs16_50ep's head). `backbone` is the configuration's
    `{"name": ..., <that backbone's sizes>}`, `net` its file."""

    conv_dim: int = 256
    mask_dim: int = 256
    enc_layers: int = 6
    enc_heads: int = 8
    enc_ffn: int = 1024
    enc_points: int = 4
    num_queries: int = 100
    hidden_dim: int = 256
    dec_heads: int = 8
    dec_ffn: int = 2048
    dec_layers: int = 9
    num_classes: int = 80
    size_divisibility: int = 32
    pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    backbone: Mapping = field(default_factory=dict)
    net: Optional[ModuleType] = field(default=None, compare=False, repr=False)

    @classmethod
    def from_dict(cls, d: Mapping, base: Path = backbones.HERE) -> "Arch":
        """From a configuration's `arch`, the backbone's file looked up under
        `base`. Without `arch.backbone` the backbone is DEFAULT_BACKBONE, its
        sizes (the keys of its PORT_KEYS) read from `arch` itself."""
        d = dict(d)
        if "backbone" in d:
            bb = dict(d.pop("backbone"))
            net = backbones.load(bb["name"], base)
        else:
            net = backbones.load(DEFAULT_BACKBONE, base)
            bb = {"name": DEFAULT_BACKBONE, **{k: d.pop(k) for k in net.PORT_KEYS if k in d}}
        names = {f.name for f in fields(cls)} - {"backbone", "net"}
        unknown = set(d) - names
        if unknown:
            raise KeyError(f"unknown architecture keys {sorted(unknown)}")
        tup = lambda v: tuple(v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items()},
                   backbone={k: tup(v) for k, v in bb.items()}, net=net)


# ---------------------------------------------------------------------------
# Names, shapes and kinds of the weights
# ---------------------------------------------------------------------------


def param_specs(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight, the backbone's first (its file's
    `param_specs`), kind one of "fan_in" (a matrix or convolution kernel),
    "zero", "one", "embed" (an embedding table), "class" (the classifier),
    "ring" (the sampling-offset bias) or a kind of the backbone's `KINDS`."""
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, cout, cin, k, bias=False, gn=False):
        out.append((f"{name}.weight", (cout, cin, k, k), "fan_in"))
        if bias:
            out.append((f"{name}.bias", (cout,), "zero"))
        if gn:
            out.append((f"{name}.norm.weight", (cout,), "one"))
            out.append((f"{name}.norm.bias", (cout,), "zero"))

    def linear(name, cout, cin, kind="fan_in"):
        out.append((f"{name}.weight", (cout, cin), kind))
        out.append((f"{name}.bias", (cout,), "zero"))

    def norm(name, c):
        out.append((f"{name}.weight", (c,), "one"))
        out.append((f"{name}.bias", (c,), "zero"))

    out.extend(a.net.param_specs(a.backbone))
    ch = a.net.channels(a.backbone)

    C, pd = a.conv_dim, "sem_seg_head.pixel_decoder"
    for i, f in enumerate(("res5", "res4", "res3")):
        conv(f"{pd}.input_proj.{i}.0", C, ch[f], 1, bias=True)
        norm(f"{pd}.input_proj.{i}.1", C)
    out.append((f"{pd}.transformer.level_embed", (3, C), "embed"))
    M, L, P = a.enc_heads, 3, a.enc_points
    for i in range(a.enc_layers):
        p = f"{pd}.transformer.encoder.layers.{i}"
        out.append((f"{p}.self_attn.sampling_offsets.weight", (M * L * P * 2, C), "fan_in"))
        out.append((f"{p}.self_attn.sampling_offsets.bias", (M * L * P * 2,), "ring"))
        linear(f"{p}.self_attn.attention_weights", M * L * P, C)
        linear(f"{p}.self_attn.value_proj", C, C)
        linear(f"{p}.self_attn.output_proj", C, C)
        norm(f"{p}.norm1", C)
        linear(f"{p}.linear1", a.enc_ffn, C)
        linear(f"{p}.linear2", C, a.enc_ffn)
        norm(f"{p}.norm2", C)
    conv(f"{pd}.adapter_1", C, ch["res2"], 1, gn=True)
    conv(f"{pd}.layer_1", C, C, 3, gn=True)
    conv(f"{pd}.mask_features", a.mask_dim, C, 1, bias=True)

    H, pr = a.hidden_dim, "sem_seg_head.predictor"
    out.append((f"{pr}.query_feat.weight", (a.num_queries, H), "embed"))
    out.append((f"{pr}.query_embed.weight", (a.num_queries, H), "embed"))
    out.append((f"{pr}.level_embed.weight", (3, H), "embed"))
    for i in range(a.dec_layers):
        for kind, attn in (("cross", "multihead_attn"), ("self", "self_attn")):
            p = f"{pr}.transformer_{kind}_attention_layers.{i}"
            out.append((f"{p}.{attn}.in_proj_weight", (3 * H, H), "fan_in"))
            out.append((f"{p}.{attn}.in_proj_bias", (3 * H,), "zero"))
            linear(f"{p}.{attn}.out_proj", H, H)
            norm(f"{p}.norm", H)
        p = f"{pr}.transformer_ffn_layers.{i}"
        linear(f"{p}.linear1", a.dec_ffn, H)
        linear(f"{p}.linear2", H, a.dec_ffn)
        norm(f"{p}.norm", H)
    norm(f"{pr}.decoder_norm", H)
    linear(f"{pr}.class_embed", a.num_classes + 1, H, kind="class")
    for j in range(3):
        linear(f"{pr}.mask_embed.layers.{j}", a.mask_dim if j == 2 else H, H)
    return out


def ring_bias(heads: int, levels: int, points: int) -> torch.Tensor:
    """Upstream's sampling-offset bias (ms_deform_attn.py:66-74): head h
    points at angle 2 pi h / heads, scaled to unit max-norm, times the
    point's index + 1. Flat (heads * levels * points * 2,)."""
    th = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    grid = torch.stack([th.cos(), th.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def conv(x, w, b=None, stride=1, padding=0):
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def sine_position(h: int, w: int, c: int, device) -> torch.Tensor:
    """DETR's PositionEmbeddingSine(c // 2, normalize=True) over an all-valid
    mask: (h * w, c), channels [y features, x features]."""
    n = c // 2
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float64, device=device) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float64, device=device) / (w + eps) * scale
    dim_t = 10000.0 ** (2 * (torch.arange(n, dtype=torch.float64, device=device) // 2) / n)
    py, px = y[:, None] / dim_t, x[:, None] / dim_t
    py = torch.stack([py[:, 0::2].sin(), py[:, 1::2].cos()], -1).flatten(1)
    px = torch.stack([px[:, 0::2].sin(), px[:, 1::2].cos()], -1).flatten(1)
    pos = torch.cat([py[:, None, :].expand(h, w, n), px[None, :, :].expand(h, w, n)], -1)
    return pos.reshape(h * w, c).float()


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def group_norm(x, P, name):
    return F.group_norm(x, 32, P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def resize(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# Pixel decoder
# ---------------------------------------------------------------------------


def ms_deform_attn_core(value, shapes, loc, attn):
    """Upstream's ms_deform_attn_core_pytorch: value (B, S, M, D), loc (B,
    Q, M, L, P, 2) in [0, 1], attn (B, Q, M, L, P) -> (B, Q, M * D)."""
    B, S, M, D = value.shape
    _, Q, _, L, Pn, _ = loc.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(B * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # (B*M, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # (B*M, D, Q, P)
    a = attn.transpose(1, 2).reshape(B * M, 1, Q, L * Pn)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)  # (B*M, D, Q)
    return out.view(B, M * D, Q).transpose(1, 2)


def deform_attn(query, ref, src, shapes, P, name, a: Arch):
    B, Q, C = query.shape
    M, L, Pn = a.enc_heads, len(shapes), a.enc_points
    value = linear(src, P[f"{name}.value_proj.weight"], P[f"{name}.value_proj.bias"])
    value = value.view(B, -1, M, C // M)
    off = linear(query, P[f"{name}.sampling_offsets.weight"],
                   P[f"{name}.sampling_offsets.bias"]).view(B, Q, M, L, Pn, 2)
    aw = linear(query, P[f"{name}.attention_weights.weight"],
                  P[f"{name}.attention_weights.bias"]).view(B, Q, M, L * Pn)
    aw = aw.softmax(-1).view(B, Q, M, L, Pn)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=query.dtype, device=query.device)
    loc = ref[None, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    out = ms_deform_attn_core(value, shapes, loc, aw)
    return linear(out, P[f"{name}.output_proj.weight"], P[f"{name}.output_proj.bias"])


def reference_points(shapes, device) -> torch.Tensor:
    """Pixel centres of every level, normalised, for every sampling level:
    (S, L, 2) as (x, y) (msdeformattn.py:141-153 with valid ratios 1)."""
    refs = []
    for h, w in shapes:
        ys = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=device) / h
        xs = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=device) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(refs, 0)[:, None, :].expand(-1, len(shapes), -1)


def pixel_decoder(feats, P, a: Arch):
    pd, C = "sem_seg_head.pixel_decoder", a.conv_dim
    srcs, poss, shapes = [], [], []
    for i, f in enumerate(("res5", "res4", "res3")):
        x = conv(feats[f], P[f"{pd}.input_proj.{i}.0.weight"], P[f"{pd}.input_proj.{i}.0.bias"])
        x = group_norm(x, P, f"{pd}.input_proj.{i}.1")
        B, _, h, w = x.shape
        shapes.append((h, w))
        srcs.append(x.flatten(2).transpose(1, 2))
        poss.append(sine_position(h, w, C, x.device) + P[f"{pd}.transformer.level_embed"][i])
    src, pos = torch.cat(srcs, 1), torch.cat(poss, 0)[None]
    ref = reference_points(shapes, src.device)
    for i in range(a.enc_layers):
        p = f"{pd}.transformer.encoder.layers.{i}"
        src = layer_norm(src + deform_attn(src + pos, ref, src, shapes, P, f"{p}.self_attn",
                                           a), P, f"{p}.norm1")
        y = linear(F.relu(linear(src, P[f"{p}.linear1.weight"], P[f"{p}.linear1.bias"])),
                     P[f"{p}.linear2.weight"], P[f"{p}.linear2.bias"])
        src = layer_norm(src + y, P, f"{p}.norm2")
    outs, start = [], 0
    for h, w in shapes:
        outs.append(src[:, start:start + h * w].transpose(1, 2).reshape(B, C, h, w))
        start += h * w
    lat = group_norm(conv(feats["res2"], P[f"{pd}.adapter_1.weight"]), P, f"{pd}.adapter_1.norm")
    y = lat + resize(outs[-1], *lat.shape[-2:])
    y = F.relu(group_norm(conv(y, P[f"{pd}.layer_1.weight"], padding=1), P, f"{pd}.layer_1.norm"))
    mask_features = conv(y, P[f"{pd}.mask_features.weight"], P[f"{pd}.mask_features.bias"])
    return mask_features, outs  # outs: res5, res4, res3 levels


# ---------------------------------------------------------------------------
# Masked-attention decoder
# ---------------------------------------------------------------------------


def mha(q_in, k_in, v_in, P, name, heads, mask=None):
    """torch.nn.MultiheadAttention (packed in_proj, batch first); `mask`
    (B, Nq, Nk) bool, True = blocked."""
    w, b = P[f"{name}.in_proj_weight"], P[f"{name}.in_proj_bias"]
    C = w.shape[1]
    D = C // heads
    q = linear(q_in, w[:C], b[:C])
    k = linear(k_in, w[C:2 * C], b[C:2 * C])
    v = linear(v_in, w[2 * C:], b[2 * C:])
    B, Nq, _ = q.shape
    Nk = k.shape[1]
    q = q.view(B, Nq, heads, D).transpose(1, 2)
    k = k.view(B, Nk, heads, D).transpose(1, 2)
    v = v.view(B, Nk, heads, D).transpose(1, 2)
    logits = torch.matmul(q / math.sqrt(D), k.transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(mask[:, None], NEG_INF)
    out = torch.matmul(logits.softmax(-1), v).transpose(1, 2).reshape(B, Nq, C)
    return linear(out, P[f"{name}.out_proj.weight"], P[f"{name}.out_proj.bias"])


def decoder(levels, mask_features, P, a: Arch):
    pr, H, Q = "sem_seg_head.predictor", a.hidden_dim, a.num_queries
    B = mask_features.shape[0]
    srcs, poss, sizes = [], [], []
    for i, x in enumerate(levels):
        h, w = x.shape[-2:]
        sizes.append((h, w))
        srcs.append(x.flatten(2).transpose(1, 2) + P[f"{pr}.level_embed.weight"][i])
        poss.append(sine_position(h, w, H, x.device)[None])

    def head(output, size):
        dec = layer_norm(output, P, f"{pr}.decoder_norm")
        logits = linear(dec, P[f"{pr}.class_embed.weight"], P[f"{pr}.class_embed.bias"])
        e = dec
        for j in range(3):
            e = linear(e, P[f"{pr}.mask_embed.layers.{j}.weight"],
                         P[f"{pr}.mask_embed.layers.{j}.bias"])
            if j < 2:
                e = F.relu(e)
        masks = torch.einsum("bqc,bchw->bqhw", e, mask_features)
        blocked = resize(masks, *size).flatten(2).sigmoid() < 0.5
        blocked = blocked & ~blocked.all(-1, keepdim=True)
        return logits, masks, blocked.detach()

    output = P[f"{pr}.query_feat.weight"][None].expand(B, Q, H)
    qpos = P[f"{pr}.query_embed.weight"][None].expand(B, Q, H)
    logits, masks, blocked = head(output, sizes[0])
    all_logits, all_masks = [logits], [masks]
    nl = len(levels)
    for i in range(a.dec_layers):
        lvl = i % nl
        p = f"{pr}.transformer_cross_attention_layers.{i}.multihead_attn"
        output = layer_norm(output + mha(output + qpos, srcs[lvl] + poss[lvl], srcs[lvl], P, p,
                                         a.dec_heads, blocked),
                            P, f"{pr}.transformer_cross_attention_layers.{i}.norm")
        p = f"{pr}.transformer_self_attention_layers.{i}"
        qk = output + qpos
        output = layer_norm(output + mha(qk, qk, output, P, f"{p}.self_attn", a.dec_heads),
                            P, f"{p}.norm")
        p = f"{pr}.transformer_ffn_layers.{i}"
        y = linear(F.relu(linear(output, P[f"{p}.linear1.weight"], P[f"{p}.linear1.bias"])),
                     P[f"{p}.linear2.weight"], P[f"{p}.linear2.bias"])
        output = layer_norm(output + y, P, f"{p}.norm")
        logits, masks, blocked = head(output, sizes[(i + 1) % nl])
        all_logits.append(logits)
        all_masks.append(masks)
    return {"pred_logits": all_logits[-1], "pred_masks": all_masks[-1],
            "aux_logits": all_logits[:-1], "aux_masks": all_masks[:-1]}


def normalize(images: torch.Tensor, a: Arch) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 255] -> normalised (B, 3, H, W)."""
    mean = torch.tensor(a.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(a.pixel_std, dtype=torch.float32, device=images.device)
    return ((images.float() - mean) / std).permute(0, 3, 1, 2)


def forward(P: Mapping[str, torch.Tensor], images: torch.Tensor, a: Arch) -> Dict[str, object]:
    """images (B, H, W, 3) RGB in [0, 255], sides multiples of
    `a.size_divisibility`. Returns pred_logits (B, Q, K+1), pred_masks (B,
    Q, H/4, W/4) and the lists aux_logits, aux_masks of the earlier heads."""
    feats = a.net.forward(normalize(images, a), P, a.backbone)
    mask_features, levels = pixel_decoder(feats, P, a)
    return decoder(levels, mask_features, P, a)
