"""Swin Transformer as Mask2Former's D2SwinTransformer builds it
(mask2former/modeling/backbone/swin.py, after Liu et al., "Swin Transformer:
Hierarchical Vision Transformer using Shifted Windows", ICCV 2021), tokens
(B, H, W, C):

- patch embedding: the image padded right and bottom to a multiple of
  `patch_size`, a p x p / p convolution, then a LayerNorm (`patch_norm`);
- a block: LayerNorm, zero padding right and bottom to a multiple of the
  window w, in odd blocks a cyclic shift by -w // 2 and the region mask (-100
  between tokens of different regions of the padded map before the shift),
  window attention (q scaled by `qk_scale` or head_dim^-0.5, q k^T plus the
  relative-position bias `relative_position_bias_table[index]` plus the
  mask, a softmax, times v, then `proj`), the windows reversed, the shift
  undone, the padding cropped, the residual added; then LayerNorm, `fc1`,
  exact GELU, `fc2` and the residual;
- patch merging between stages: padding to even sizes, the four strided
  views (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2) concatenated,
  LayerNorm(4C) and a bias-free Linear(4C, 2C);
- outputs: `norm0`..`norm3` on each stage's tokens before its merging, as
  `res2`..`res5`.

Sizes: the keys of PORT_KEYS (embed 192, depths (2, 2, 18, 2), heads (6,
12, 24, 48), window 12 for Swin-L at 384). LayerNorms take eps 1e-5.

Departures from upstream:
- no stochastic depth and no dropout (upstream trains with a drop-path
  rate of 0.3; `drop_rate` and `attn_drop_rate` are 0 there too);
- seeded weights (`port_bench/weights.py`: the bias tables N(0, 0.02^2) as
  upstream's `trunc_normal_(std=.02)`, Linear and convolution weights by
  fan-in, biases 0, LayerNorms 1 and 0), not the IN21k checkpoint;
- one setting of each switch: no absolute position table (`ape`), a
  patch-embedding LayerNorm (`patch_norm`), biases on `qkv` (`qkv_bias`),
  as Mask2Former's Swin configurations set them; `FIXED` raises on others.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

PORT_NAME = "swin"
PORT_KEYS = {k: f"model.backbone.swin.{k}" for k in (
    "embed_dim", "depths", "num_heads", "window_size", "patch_size", "mlp_ratio", "qkv_bias",
    "qk_scale", "ape", "patch_norm", "pretrain_img_size", "use_checkpoint")}
KINDS = {"swin_rel_bias": 0.02}
FIXED = {"ape": False, "patch_norm": True, "qkv_bias": True}
MASK_FILL = -100.0


def _check(sizes: Mapping) -> None:
    other = {k: sizes[k] for k in FIXED if sizes[k] != FIXED[k]}
    if other:
        raise ValueError(f"the reference Swin runs {FIXED}, not {other}")


def param_specs(sizes: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    _check(sizes)
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def linear(name, cout, cin, bias=True):
        out.append((f"{name}.weight", (cout, cin), "fan_in"))
        if bias:
            out.append((f"{name}.bias", (cout,), "zero"))

    def norm(name, c):
        out.append((f"{name}.weight", (c,), "one"))
        out.append((f"{name}.bias", (c,), "zero"))

    C, p, w = sizes["embed_dim"], sizes["patch_size"], sizes["window_size"]
    out.append(("backbone.patch_embed.proj.weight", (C, 3, p, p), "fan_in"))
    out.append(("backbone.patch_embed.proj.bias", (C,), "zero"))
    norm("backbone.patch_embed.norm", C)
    stages = len(sizes["depths"])
    for s, (depth, heads) in enumerate(zip(sizes["depths"], sizes["num_heads"])):
        for i in range(depth):
            b = f"backbone.layers.{s}.blocks.{i}"
            norm(f"{b}.norm1", C)
            out.append((f"{b}.attn.relative_position_bias_table", ((2 * w - 1) ** 2, heads),
                        "swin_rel_bias"))
            linear(f"{b}.attn.qkv", 3 * C, C)
            linear(f"{b}.attn.proj", C, C)
            norm(f"{b}.norm2", C)
            hidden = int(C * sizes["mlp_ratio"])
            linear(f"{b}.mlp.fc1", hidden, C)
            linear(f"{b}.mlp.fc2", C, hidden)
        if s < stages - 1:
            norm(f"backbone.layers.{s}.downsample.norm", 4 * C)
            linear(f"backbone.layers.{s}.downsample.reduction", 2 * C, 4 * C, bias=False)
            C *= 2
    C = sizes["embed_dim"]
    for s in range(stages):
        norm(f"backbone.norm{s}", C * 2 ** s)
    return out


def channels(sizes: Mapping) -> Dict[str, int]:
    return {f"res{s + 2}": sizes["embed_dim"] * 2 ** s for s in range(4)}


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def linear(x, P, name):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))  # merging's has no bias


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w * w, C), windows batch-major, then by row."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    B = x.shape[0] // ((H // w) * (W // w))
    x = x.view(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(w: int, device) -> torch.Tensor:
    """(w * w, w * w) rows into the (2w - 1)^2 bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(w, device=device),
                                        torch.arange(w, device=device), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    return (rel[:, :, 0] + w - 1) * (2 * w - 1) + (rel[:, :, 1] + w - 1)


def region_mask(hp: int, wp: int, w: int, shift: int, device) -> torch.Tensor:
    """(nW, w * w, w * w): MASK_FILL between tokens whose regions of the
    padded map, counted before the shift, differ; 0 elsewhere."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cuts = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    n = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = n
            n += 1
    win = window_partition(img, w).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return diff.masked_fill(diff != 0, MASK_FILL).masked_fill(diff == 0, 0.0)


def window_attention(x, P, name, heads, w, scale, mask):
    """x (B * nW, N, C) with N = w * w; mask (nW, N, N) or None."""
    Bw, N, C = x.shape
    qkv = linear(x, P, f"{name}.qkv").reshape(Bw, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * scale, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1)
    table = P[f"{name}.relative_position_bias_table"]
    bias = table[relative_position_index(w, x.device).reshape(-1)].view(N, N, heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.view(Bw // nW, nW, heads, N, N) + mask[None, :, None]).view(Bw, heads, N, N)
    attn = attn.softmax(-1)
    return linear((attn @ v).transpose(1, 2).reshape(Bw, N, C), P, f"{name}.proj")


def block(x, P, name, heads, w, shift, sizes):
    B, H, W, C = x.shape
    hp, wp = -(-H // w) * w, -(-W // w) * w
    y = F.pad(layer_norm(x, P, f"{name}.norm1"), (0, 0, 0, wp - W, 0, hp - H))
    mask = None
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), (1, 2))
        mask = region_mask(hp, wp, w, shift, x.device)
    scale = sizes["qk_scale"] or (C // heads) ** -0.5
    y = window_attention(window_partition(y, w), P, f"{name}.attn", heads, w, scale, mask)
    y = window_reverse(y, w, hp, wp)
    if shift > 0:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y[:, :H, :W]
    y = linear(F.gelu(linear(layer_norm(x, P, f"{name}.norm2"), P, f"{name}.mlp.fc1")),
               P, f"{name}.mlp.fc2")
    return x + y


def patch_merging(x, P, name):
    H, W = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return linear(layer_norm(x, P, f"{name}.norm"), P, f"{name}.reduction")


def forward(x: torch.Tensor, P, sizes: Mapping) -> Dict[str, torch.Tensor]:
    _check(sizes)
    p, w = sizes["patch_size"], sizes["window_size"]
    H, W = x.shape[2:]
    x = F.conv2d(F.pad(x, (0, (-W) % p, 0, (-H) % p)), P["backbone.patch_embed.proj.weight"],
                 P["backbone.patch_embed.proj.bias"], stride=p).permute(0, 2, 3, 1)
    x = layer_norm(x, P, "backbone.patch_embed.norm")
    feats = {}
    stages = len(sizes["depths"])
    for s, (depth, heads) in enumerate(zip(sizes["depths"], sizes["num_heads"])):
        for i in range(depth):
            x = block(x, P, f"backbone.layers.{s}.blocks.{i}", heads, w,
                      0 if i % 2 == 0 else w // 2, sizes)
        feats[f"res{s + 2}"] = layer_norm(x, P, f"backbone.norm{s}").permute(0, 3, 1, 2)
        if s < stages - 1:
            x = patch_merging(x, P, f"backbone.layers.{s}.downsample")
    return feats
