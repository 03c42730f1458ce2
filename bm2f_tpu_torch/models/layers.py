"""Shared PyTorch building blocks, named as detectron2 names them so that a
detectron2 checkpoint (and, through `utils/convert_weights.py`, a JAX
variable tree) maps onto `state_dict()` key for key.

Compute dtype, as flax's `dtype=` does it: parameters stay f32, and every
layer computes in the dtype of its input, casting its weights to it.
`Linear`, `Conv2d`, `FrozenBatchNorm` and `MultiHeadAttention` run wholly in
that dtype (attention's softmax in f32); `LayerNorm` and `GroupNorm` take
their statistics and affine map in f32 and return the input's dtype. The
models cast their inputs once, where the JAX package does. A model served
in bf16 has its weights cast once instead (`cast_weights_`, called by
`MaskFormer.cast_weights_for_inference_`), so that a request casts none."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bm2f_tpu_torch.parallel import tp as tparallel

_CONSTANTS: "OrderedDict" = OrderedDict()
_CONSTANTS_LOCK = threading.Lock()
_CONSTANTS_CAP = 64


def device_constant(key: Hashable, build: Callable, device, dtype) -> torch.Tensor:
    """The constant `torch.tensor(build(), dtype, device)`, which callers
    must not modify in place. A copy from pageable host memory to the card
    waits for every launch queued before it, so a forward that made its
    tables so would hold the host to the device; on the card each (key,
    device, dtype) is copied once and kept (an LRU of 64), in a memory pool
    of its own (`utils.memory.kept_allocations`). On the CPU it is built anew
    each call."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.tensor(build(), dtype=dtype)
    k = (key, device, dtype)
    with _CONSTANTS_LOCK:
        t = _CONSTANTS.get(k)
        if t is not None:
            _CONSTANTS.move_to_end(k)
            return t
    from bm2f_tpu_torch.utils.memory import kept_allocations

    with kept_allocations(device):
        t = torch.tensor(build(), dtype=dtype, device=device)
    with _CONSTANTS_LOCK:
        _CONSTANTS[k] = t
        while len(_CONSTANTS) > _CONSTANTS_CAP:
            _CONSTANTS.popitem(last=False)
    return t


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
        return (x * cast(self.scale, x.dtype)[:, None, None]
                + cast(self.bias, x.dtype)[:, None, None])


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in f32, or as it is when it is f64."""
    return x if x.dtype == torch.float64 else x.float()


def cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """A weight `p` in `dtype`: `p` itself when it is already (f32 training,
    or a model whose weights `cast_weights_` cast once), else a cast that
    autograd follows back to the f32 parameter."""
    return p if p is None else p.to(dtype)


@torch.no_grad()
def cast_weights_(module: nn.Module, dtype: torch.dtype) -> None:
    """For inference in `dtype`: casts once, in place, every weight that
    `module`'s layers would cast to their input's dtype at each call, that
    is every floating parameter and buffer outside LayerNorm and GroupNorm
    (which compute in f32 and keep f32 weights). A request then casts no
    weight, which on the card saves a launch per weight of host time. The
    parameters are no longer f32: not for training."""
    for m in module.modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            continue
        for p in m.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(m, name, b.to(dtype))


class Linear(nn.Linear):
    """nn.Linear in the input's dtype."""

    def forward(self, x):
        return F.linear(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """detectron2's Conv2d, in the input's dtype: a convolution with an
    optional norm attached as the `norm` child (so its keys read
    `<conv>.norm.*`)."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        x = self._conv_forward(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))
        return self.norm(x) if self.norm is not None else x


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm(dtype=x.dtype): statistics and affine map in f32 (in
    f64 for an f64 input, as a reference computes)."""

    def forward(self, x):
        return super().forward(at_least_f32(x)).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax GroupNorm(dtype=x.dtype): statistics and affine map in f32 (in
    f64 for an f64 input, as a reference computes)."""

    def forward(self, x):
        return super().forward(at_least_f32(x)).to(x.dtype)


def get_norm(name: str, features: int) -> Optional[nn.Module]:
    if name in ("", None, "none"):
        return None
    if name == "group_norm":  # detectron2 "GN" = GroupNorm(32, C)
        return GroupNorm(32, features, eps=1e-5)
    if name == "layer_norm":
        return LayerNorm(features, eps=1e-5)
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
            Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Multi-head attention in torch nn.MultiheadAttention's parameter
    layout (packed `in_proj_weight` (3C, C), `in_proj_bias`, `out_proj`),
    batch-first (B, N, C), in the query's dtype. `attn_bias` is an additive
    float bias broadcastable to (B, heads, Nq, Nk); the softmax runs in
    f32 (f64 for an f64 query). Under tensor parallelism (`tp`, see
    `parallel.tp`) it runs the rank's heads: q, k and v column-parallel
    by head, `out_proj` row-parallel, a per-head `attn_bias` sliced."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        self.tp = None

    def tp_splits(self, size: int):
        packed = {"in_proj_weight": tparallel.PACKED, "in_proj_bias": tparallel.PACKED}
        return tparallel.head_splits(size, self.num_heads, packed, ("out_proj.weight",))

    def tp_departures(self, size: int):
        C = self.out_proj.in_features
        return tparallel.head_departures(size, self.num_heads, C,
                                         ("in_proj_weight", "in_proj_bias"),
                                         ("out_proj.weight",), 3 * C)

    def forward(self, query, key, value, attn_bias=None):
        H = self.num_heads
        D = self.out_proj.in_features // H
        if self.tp is not None:
            query, key, value = tparallel.copy_inputs(self.tp, query, key, value)
            H //= self.tp.size
            if attn_bias is not None and attn_bias.dim() == 4 and attn_bias.shape[1] > 1:
                attn_bias = attn_bias.narrow(1, self.tp.rank * H, H)
        C = H * D
        w, b = cast(self.in_proj_weight, query.dtype), cast(self.in_proj_bias, query.dtype)
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
        probs = torch.softmax(at_least_f32(logits), dim=-1).to(q.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, Nq, C)
        if self.tp is not None:
            return tparallel.row_linear(self.out_proj, out, self.tp)
        return self.out_proj(out)


# ---------------------------------------------------------------------------
# From-scratch initialisation (seeded), following the JAX package's inits
# ---------------------------------------------------------------------------


# the standard deviation of a standard normal cut at +-2 (flax's
# `truncated_normal` divides its stddev by it)
TRUNC_NORMAL_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    receptive = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded from-scratch init of every parameter, by name:
    - ResNet convolutions: c2_msra_fill (normal, std sqrt(2 / fan_out));
    - a backbone that sets `torch_linear_init` (Swin): Linear and conv
      weights U(+-1/sqrt(fan_in)); its `relative_position_bias_table` and
      `absolute_pos_embed` flax's truncated normal, std 0.02 (a standard
      normal cut at +-2, scaled to std 0.02);
    - FPN adapters/layers, `mask_features` and the convs that set
      `c2_xavier_init` (MaskFormer-v1's `input_proj`s and per-pixel
      classifier): c2_xavier_fill;
    - `mask_embed` weights: torch Linear default U(+-1/sqrt(fan_in)), bias 0;
    - deformable `sampling_offsets`/`attention_weights`: weights 0, offset
      bias on the ring (reference ms_deform_attn.py:66-74);
    - embeddings (`level_embed`, `query_feat`, `query_embed`): N(0, 1);
    - norms: weight 1, bias 0; every other matrix xavier_uniform, bias 0.
    Each parameter draws from `generator` in `named_parameters()` order.
    FrozenBN buffers keep their identity init."""
    mods = dict(module.named_modules())
    torch_linear_backbone = getattr(mods.get("backbone"), "torch_linear_init", False)
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
        elif leaf in ("relative_position_bias_table", "absolute_pos_embed"):
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.mul_(0.02 / TRUNC_NORMAL_STD)
        elif name.startswith("backbone.") and torch_linear_backbone:
            fan_in, _ = _fans(p)
            b = 1.0 / fan_in**0.5
            p.uniform_(-b, b, generator=generator)
        elif name.startswith("backbone."):
            _, fan_out = _fans(p)
            p.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
        elif ".mask_embed." in f".{name}":
            fan_in, _ = _fans(p)
            b = 1.0 / fan_in**0.5
            p.uniform_(-b, b, generator=generator)
        elif (getattr(owner, "c2_xavier_init", False)
              or any(f".{k}" in f".{name}" for k in ("adapter_", "layer_", "mask_features."))):
            fan_in, _ = _fans(p)
            b = (3.0 / fan_in) ** 0.5
            p.uniform_(-b, b, generator=generator)
        else:
            fan_in, fan_out = _fans(p)
            b = (6.0 / (fan_in + fan_out)) ** 0.5
            p.uniform_(-b, b, generator=generator)
