"""Shared PyTorch building blocks, named as detectron2 names them so that a
detectron2 checkpoint (and, through `utils/convert_weights.py`, a JAX
variable tree) maps onto `state_dict()` key for key."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """detectron2 FrozenBN folded to an affine map: `scale` and `bias`
    buffers (never trained). A checkpoint's {weight, bias, running_mean,
    running_var} fold at load time: scale = w / sqrt(var + 1e-5),
    bias = b - mean * scale."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x):  # NCHW
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class Conv2d(nn.Conv2d):
    """detectron2's Conv2d: a convolution with an optional norm attached as
    the `norm` child (so its keys read `<conv>.norm.*`)."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        x = super().forward(x)
        return self.norm(x) if self.norm is not None else x


def get_norm(name: str, features: int) -> Optional[nn.Module]:
    if name in ("", None, "none"):
        return None
    if name == "group_norm":  # detectron2 "GN" = GroupNorm(32, C)
        return nn.GroupNorm(32, features, eps=1e-5)
    if name == "layer_norm":
        return nn.LayerNorm(features, eps=1e-5)
    if name == "frozen_bn":
        return FrozenBatchNorm(features)
    raise ValueError(f"unknown norm {name!r}")


class MLP(nn.Module):
    """DETR-style MLP: (num_layers-1) hidden ReLU layers + linear output
    (reference: mask2former_transformer_decoder.py:192-204)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Multi-head attention in torch nn.MultiheadAttention's parameter
    layout (packed `in_proj_weight` (3C, C), `in_proj_bias`, `out_proj`),
    batch-first (B, N, C). `attn_bias` is an additive float bias
    broadcastable to (B, heads, Nq, Nk); the softmax runs in f32."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, attn_bias=None):
        C = query.shape[-1]
        H = self.num_heads
        D = C // H
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:C], b[:C])
        k = F.linear(key, w[C:2 * C], b[C:2 * C])
        v = F.linear(value, w[2 * C:], b[2 * C:])
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        q = q.reshape(B, Nq, H, D).transpose(1, 2)
        k = k.reshape(B, Nk, H, D).transpose(1, 2)
        v = v.reshape(B, Nk, H, D).transpose(1, 2)
        logits = (q * (1.0 / D**0.5)) @ k.transpose(-1, -2)
        if attn_bias is not None:
            logits = logits + attn_bias.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, Nq, C)
        return self.out_proj(out)


# ---------------------------------------------------------------------------
# From-scratch initialisation (seeded), following the JAX package's inits
# ---------------------------------------------------------------------------


def _fans(w: torch.Tensor):
    receptive = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded from-scratch init of every parameter, by name:
    - backbone convolutions: c2_msra_fill (normal, std sqrt(2 / fan_out));
    - FPN adapters/layers and `mask_features`: c2_xavier_fill;
    - `mask_embed` weights: torch Linear default U(+-1/sqrt(fan_in)), bias 0;
    - deformable `sampling_offsets`/`attention_weights`: weights 0, offset
      bias on the ring (reference ms_deform_attn.py:66-74);
    - embeddings (`level_embed`, `query_feat`, `query_embed`): N(0, 1);
    - norms: weight 1, bias 0; every other matrix xavier_uniform, bias 0.
    Each parameter draws from `generator` in `named_parameters()` order.
    FrozenBN buffers keep their identity init."""
    mods = dict(module.named_modules())
    for name, p in module.named_parameters():
        owner = mods[name.rpartition(".")[0]] if "." in name else module
        leaf = name.rpartition(".")[2]
        if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "level_embed" or isinstance(owner, nn.Embedding):
            p.normal_(0.0, 1.0, generator=generator)
        elif name.endswith("sampling_offsets.bias"):
            p.copy_(mods[name.rsplit(".", 2)[0]].ring_bias())
        elif ".sampling_offsets." in name or ".attention_weights." in name:
            p.zero_()
        elif leaf in ("bias", "in_proj_bias"):
            p.zero_()
        elif name.startswith("backbone."):
            _, fan_out = _fans(p)
            p.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
        elif ".mask_embed." in f".{name}":
            fan_in, _ = _fans(p)
            b = 1.0 / fan_in**0.5
            p.uniform_(-b, b, generator=generator)
        elif any(f".{k}" in f".{name}" for k in ("adapter_", "layer_", "mask_features.")):
            fan_in, _ = _fans(p)
            b = (3.0 / fan_in) ** 0.5
            p.uniform_(-b, b, generator=generator)
        else:
            fan_in, fan_out = _fans(p)
            b = (6.0 / (fan_in + fan_out)) ** 0.5
            p.uniform_(-b, b, generator=generator)
