"""Tensor parallelism over the mesh's model group: the counterpart of the JAX
package's `parallel/tp.py` (bm2f_tpu/parallel/tp.py:47-111), as Megatron's
column- and row-parallel layers.

JAX attaches PartitionSpecs to the state and lets GSPMD place the
collectives. The port computes on local shards and places them itself, with
Megatron's conjugate pair (`copy_to_model`, f, and `reduce_from_model`, g):

- a column-parallel layer (`value_proj`, `linear1`, Swin `mlp.fc1`, the
  packed `in_proj_weight` and Swin `qkv`) holds its rank's share of the
  output features, weight and bias; its input goes through f, the identity
  forward whose backward sums the input's gradient over the model group;
- a row-parallel layer (`output_proj`, `linear2`, Swin `mlp.fc2`,
  `out_proj`, Swin `proj`, Swin `downsample.reduction`) holds its rank's
  share of the input features; its partial product goes through g, a sum
  over the model group forward and the identity backward, and its bias,
  replicated as in JAX ("added after the contraction", tp.py:22-23), is
  added once, after the sum;
- everything else is replicated, and every rank of a model group computes
  it on the same rows.

Each module that can run so says which of its parameters split, and on
which dimension, in `tp_splits(size)` (empty where it cannot), and runs on
its share when its `tp` attribute holds a `ModelShard`. A rule fires only
where the split dimension divides by the model size, as in JAX. Two
departures from the JAX rule set, both kept replicated where JAX shards:

- the packed (3C, C) `in_proj_weight` and Swin `qkv` split per head: rank m
  holds rows [m C/T, (m+1) C/T) of each of q, k and v (`Split.blocks` 3),
  where JAX splits the packed dimension as one (at T = 2 rank 0 holds q and
  half of k). The bytes are the same;
- an attention whose heads do not divide by T cannot split by head, though
  its features may (Swin-T's and Swin-S's 3 heads at T = 2, Swin-L's 6 at
  T = 4): its `qkv`/`in_proj` and `proj`/`out_proj` stay replicated
  (`departures` lists them).

Parameters that stay replicated but are indexed by head (the deformable
`sampling_offsets` and `attention_weights`, Swin's
`relative_position_bias_table`) are read through f and sliced to the
rank's heads, so that their gradient, partial on each rank, is summed over
the model group and every replicated leaf stays bitwise equal across it.

`shard_model_` cuts a full model's parameters to its rank's shares;
`shard_state` and `gather_state` move a state dict between the full layout
(what a checkpoint, the converter and a one-process run hold) and a rank's.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


class Split(NamedTuple):
    """How a parameter splits over the model group: along `dim`, which
    holds `blocks` equal parts (q, k and v for a packed projection), each
    split into the ranks' contiguous shares."""

    dim: int
    blocks: int = 1


class ModelShard(NamedTuple):
    """What a module that runs on its share knows of the model group: this
    rank's place in it, its size and its process group."""

    rank: int
    size: int
    group: object


COLUMN, ROW, PACKED = Split(0), Split(1), Split(0, 3)


# -- Megatron's f and g ---------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum over the model group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


def copy_inputs(tp: ModelShard, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """f on each distinct input (a tensor passed twice goes through once)."""
    done: Dict[int, torch.Tensor] = {}
    return tuple(done.setdefault(id(x), copy_to_model(x, tp)) for x in xs)


def row_linear(linear: nn.Linear, x: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    """A row-parallel `linear` on its share `x` of the input features: the
    partial product summed over the model group, then the bias, once."""
    y = reduce_from_model(F.linear(x, linear.weight.to(x.dtype)), tp)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


def ffn(x: torch.Tensor, first: nn.Linear, second: nn.Linear, act,
        tp: Optional[ModelShard]) -> torch.Tensor:
    """second(act(first(x))): as it is without `tp`; column-parallel
    `first` and row-parallel `second` with it."""
    if tp is None:
        return second(act(first(x)))
    return row_linear(second, act(first(copy_to_model(x, tp))), tp)


def ffn_splits(first: str, second: str, hidden: int, size: int) -> Dict[str, Split]:
    """The FFN pair's rules (JAX: `linear1`/`mlp_fc1` kernel and bias on
    their output, `linear2`/`mlp_fc2` kernel on its input, its bias
    replicated), where the hidden width divides."""
    if size <= 1 or hidden % size:
        return {}
    return {f"{first}.weight": COLUMN, f"{first}.bias": COLUMN, f"{second}.weight": ROW}


class ParallelFFN:
    """For a layer whose FFN is `linear1` -> ReLU -> `linear2` (the
    deformable encoder's, the masked decoder's, the DETR layers'): the
    pair's rules, and `ffn`, which runs it column- and row-parallel when
    the layer's `tp` is set."""

    tp = None

    def tp_splits(self, size: int) -> Dict[str, Split]:
        return ffn_splits("linear1", "linear2", self.linear1.out_features, size)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return ffn(x, self.linear1, self.linear2, F.relu, self.tp)


def head_splits(size: int, heads: int, column: Mapping[str, Split],
                row: Tuple[str, ...]) -> Dict[str, Split]:
    """An attention's rules: its `column` projections and `row` output
    projections split by head, where the heads divide by `size`."""
    if size <= 1 or heads % size:
        return {}
    return {**column, **{name: ROW for name in row}}


def head_departures(size: int, heads: int, width: int, column: Tuple[str, ...],
                    row: Tuple[str, ...], column_width: Optional[int] = None
                    ) -> Tuple[str, ...]:
    """What JAX shards of an attention whose heads do not divide by `size`:
    the `column` leaves where their output width (`column_width`, 3 `width`
    for a packed projection) divides, the `row` ones where `width` does."""
    if size <= 1 or not heads % size:
        return ()
    cw = width if column_width is None else column_width
    return (column if cw % size == 0 else ()) + (row if width % size == 0 else ())


def head_slice(t: torch.Tensor, tp: ModelShard, dim: int, heads: int) -> torch.Tensor:
    """The rank's heads of a replicated, head-major parameter `t` along
    `dim` (`heads` equal blocks), read through f, so that the gradient each
    rank's heads give it is summed over the model group."""
    n = t.shape[dim] // heads * (heads // tp.size)
    return copy_to_model(t, tp).narrow(dim, tp.rank * n, n)


# -- the layout and the state -----------------------------------------------------------------


def layout(model: nn.Module, size: int) -> Dict[str, Split]:
    """Every parameter of `model` that splits over a model group of `size`,
    by its full name. `model` holds full parameters or a rank's shares
    (a module's rules read its configuration, not its parameters)."""
    out: Dict[str, Split] = {}
    if size <= 1:
        return out
    for prefix, m in model.named_modules():
        rules = getattr(m, "tp_splits", None)
        for name, split in (rules(size) if rules is not None else {}).items():
            out[f"{prefix}.{name}" if prefix else name] = split
    return out


def shard(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s share of the full tensor `t` (a new tensor)."""
    parts = t.chunk(split.blocks, split.dim)
    return torch.cat([p.chunk(size, split.dim)[rank] for p in parts],
                     split.dim).contiguous()


def gather(t: torch.Tensor, split: Split, tp: ModelShard) -> torch.Tensor:
    """The full tensor from every rank's share `t` (a collective of the
    model group)."""
    shares = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(shares, t.contiguous(), group=tp.group)
    blocks = [s.chunk(split.blocks, split.dim) for s in shares]
    return torch.cat([torch.cat([b[i] for b in blocks], split.dim)
                      for i in range(split.blocks)], split.dim)


def shard_state(state: Mapping[str, torch.Tensor], splits: Mapping[str, Split],
                rank: int, size: int) -> Dict[str, torch.Tensor]:
    """A full state dict (a model's, or a moment's by parameter name) cut
    to rank `rank`'s shares; other entries as they are."""
    return {k: shard(v, splits[k], rank, size) if k in splits else v
            for k, v in state.items()}


def gather_state(state: Mapping[str, torch.Tensor], splits: Mapping[str, Split],
                 tp: ModelShard) -> Dict[str, torch.Tensor]:
    """`shard_state` undone: every rank's shares gathered into full
    tensors, in `state`'s order (every rank of the model group calls it)."""
    return {k: gather(v, splits[k], tp) if k in splits else v for k, v in state.items()}


@torch.no_grad()
def shard_model_(model: nn.Module, tp: ModelShard) -> Dict[str, Split]:
    """Cuts every parameter of a full `model` that splits to the rank's
    share, in place (the Parameter objects stay), and sets `tp` on every
    module that runs on shares. Returns the layout."""
    splits = layout(model, tp.size)
    params = dict(model.named_parameters())
    for name, split in splits.items():
        params[name].data = shard(params[name].data, split, tp.rank, tp.size)
    for m in model.modules():
        rules = getattr(m, "tp_splits", None)
        if rules is not None and rules(tp.size):
            m.tp = tp
    return splits


def count_sharded(model: nn.Module, size: int) -> Tuple[int, int, int]:
    """(leaves that split, their bytes, every parameter's bytes) of a full
    `model` at a model group of `size` (JAX's `count_sharded` of the
    parameters). A rank's parameters take total - sharded (size - 1) /
    size bytes, and each AdamW moment as many."""
    splits = layout(model, size)
    n = sb = tb = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        tb += nbytes
        if name in splits:
            n += 1
            sb += nbytes
    return n, sb, tb


def departures(model: nn.Module, size: int) -> Dict[str, int]:
    """The parameters the JAX rule set shards at `size` that the port keeps
    replicated, with their bytes: the packed projections and output
    projections of attention whose heads do not divide by `size` while its
    features do. Each module that can depart lists its own
    (`tp_departures`)."""
    out: Dict[str, int] = {}
    params = dict(model.named_parameters())
    for prefix, m in model.named_modules():
        rules = getattr(m, "tp_departures", None)
        for name in (rules(size) if rules is not None else ()):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = params[full].numel() * params[full].element_size()
    return out
