"""Tensor parallelism's rules and layout (`bm2f_tpu_torch/parallel/tp.py`,
`parallel/mesh.py`), against the JAX package's (bm2f_tpu/parallel/tp.py):

- the rule table leaf for leaf: every JAX leaf's PartitionSpec at model
  sizes 2 and 4 is carried through the weight converter's name map as a
  marker array (an arange along the sharded axis, a constant where
  replicated), whose one strided axis after the converter's transposes and
  unstacking is the port dimension JAX shards; the port's `layout` must
  split exactly there, except at the departures this file lists;
- the per-rank bytes: JAX's `count_sharded` of the parameters less the
  departures' bytes is the port's, and a rank's share of a model cut by
  `shard_model_` holds total - sharded (T - 1) / T bytes;
- `shard` / `gather` of packed and plain leaves, and the (data, model) grid
  of ranks against JAX's `create_mesh` over four spawned gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.parallel.mesh import create_mesh
from bm2f_tpu.parallel.tp import count_sharded as jax_count_sharded
from bm2f_tpu.parallel.tp import partition_spec
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models.maskformer import MaskFormer
from bm2f_tpu_torch.parallel import tp as tparallel
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy
from bm2f_tpu_torch.video.video_maskformer import VideoMaskFormer
from torch_ddp_cases import run_ranks

V1 = {"model.pixel_decoder.name": "transformer_fpn", "model.decoder.name": "standard"}
CASES = {"coco_instance_r50": ("coco_instance_r50", {}),
         "ytvis2019_video_r50": ("ytvis2019_video_r50", {}),
         "coco_instance_swin_t": ("coco_instance_swin_t", {}),
         "v1_transformer_fpn_standard": ("coco_instance_r50", V1)}

# the leaves JAX shards and the port keeps replicated: the attention of
# Swin-T's stages whose heads (3, 6, 12, 24) do not divide by T, while their
# widths (96, 192, ...) do
_SWIN_ATTN = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight")
DEPARTURES = {
    ("coco_instance_swin_t", 2): {f"backbone.layers.0.blocks.{b}.{n}"
                                  for b in (0, 1) for n in _SWIN_ATTN},
    ("coco_instance_swin_t", 4): {f"backbone.layers.{s}.blocks.{b}.{n}"
                                  for s in (0, 1) for b in (0, 1) for n in _SWIN_ATTN},
}
# the packed projections, split per head (q, k and v each by the ranks)
# where JAX splits the packed dimension as one
PACKED = ("in_proj_weight", "in_proj_bias", "attn.qkv.weight", "attn.qkv.bias")


def _jax_shapes(config, over):
    cfg = jax_get_config(config, over)
    video = cfg.task == "video"
    model = (jax_build_video_model if video else jax_build_model)(cfg)
    x = jnp.zeros((1, 2, 64, 64, 3) if video else (1, 64, 64, 3), jnp.float32)
    return cfg, jax.eval_shape(model.init, jax.random.PRNGKey(0), x)


def _port_model(config, over):
    cfg = get_config(config, over)
    cls = VideoMaskFormer if cfg.task == "video" else MaskFormer
    with torch.device("meta"):
        return cls(cfg.model)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    config, over = CASES[request.param]
    jcfg, shapes = _jax_shapes(config, over)
    return request.param, jcfg, shapes, _port_model(config, over)


def _marker(path, leaf, size):
    """A zero-cost array of the leaf's shape: arange along the axis JAX
    shards over "model", a constant where it replicates."""
    spec = partition_spec(path, leaf, size)
    if spec == P():
        return np.broadcast_to(np.float32(0), leaf.shape)
    axis = list(spec).index("model")
    ramp = np.arange(leaf.shape[axis], dtype=np.float32).reshape(
        [-1 if a == axis else 1 for a in range(len(leaf.shape))])
    return np.broadcast_to(ramp, leaf.shape)


def _jax_dims(jcfg, shapes, size):
    """{port key: the dimension JAX shards, or None}."""
    markers = jax.tree_util.tree_map_with_path(lambda p, x: _marker(p, x, size), shapes)
    flat = jax_tree_to_numpy(markers, pixel_decoder=jcfg.model.pixel_decoder.name)
    out = {}
    for key, arr in flat.items():
        axes = [a for a, st in enumerate(arr.strides) if st != 0 and arr.shape[a] > 1]
        assert len(axes) <= 1, (key, arr.strides)
        out[key] = axes[0] if axes else None
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_rule_table_matches_jax_leaf_for_leaf(case, size):
    name, jcfg, shapes, model = case
    jdims = _jax_dims(jcfg, shapes, size)
    splits = tparallel.layout(model, size)
    departures = tparallel.departures(model, size)
    assert set(departures) == DEPARTURES.get((name, size), set())
    params = dict(model.named_parameters())
    assert set(params) <= set(jdims)
    assert set(splits) <= set(params)
    fired = 0
    for key, jdim in jdims.items():
        split = splits.get(key)
        if key in departures:
            assert jdim is not None and split is None, key
            continue
        assert (None if split is None else split.dim) == jdim, (key, split, jdim)
        if split is not None:
            fired += 1
            assert split.blocks == (3 if key.endswith(PACKED) else 1), (key, split)
    assert fired == len(splits) > 0


def test_per_rank_bytes_are_jax_count_less_the_departures(case):
    """JAX's `count_sharded` of the parameters at T = 2 and 4: the port's
    sharded bytes are JAX's less the departures'; its total the same; and
    a rank of a model cut by `shard_model_` holds total - sharded (T-1)/T
    bytes (each AdamW moment as many, mirroring the parameters)."""
    name, jcfg, shapes, _ = case
    params = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
                          shapes["params"])
    for size in (2, 4):
        model = _port_model(*CASES[name])
        _, jsb, jtb = jax_count_sharded(params, create_mesh(1, size, jax.devices()[:size]))
        n, sb, tb = tparallel.count_sharded(model, size)
        dep = sum(tparallel.departures(model, size).values())
        assert tb == jtb and sb == jsb - dep and n > 0, (name, size, sb, jsb, dep)
        for rank in (0, size - 1):
            m = _port_model(*CASES[name])
            tparallel.shard_model_(m, tparallel.ModelShard(rank, size, None))
            local = sum(p.numel() * p.element_size() for p in m.parameters())
            assert local == tb - sb * (size - 1) // size, (name, size, rank)


@pytest.mark.parametrize("split,shape", [(tparallel.COLUMN, (12, 5)), (tparallel.ROW, (5, 12)),
                                         (tparallel.PACKED, (24, 4)),
                                         (tparallel.PACKED, (24,))])
def test_shard_takes_contiguous_shares_of_each_block(split, shape):
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    shares = [tparallel.shard(t, split, r, 2) for r in range(2)]
    if split.blocks == 3:  # rank r: rows [r*4, (r+1)*4) of q, k and v
        for r, s in enumerate(shares):
            want = torch.cat([t[b * 8 + r * 4:b * 8 + (r + 1) * 4] for b in range(3)])
            assert torch.equal(s, want)
    else:
        assert torch.equal(torch.cat(shares, split.dim), t)


def _grid_and_gather():
    """In each of 4 ranks: the (data, model) grid at model 2, the mesh's
    group members, and a packed and a row leaf gathered from the shares."""
    import torch.distributed as dist

    from bm2f_tpu_torch.parallel import data_size, init_mesh, model_rank, model_size

    mesh = init_mesh(2)
    assert init_mesh(2) is mesh  # built once per default group
    for bad in (3, 8):
        with pytest.raises(ValueError, match=f"mesh.model={bad}"):
            init_mesh(bad)
    seen = {}
    for key, group in (("data", mesh.data_group), ("model", mesh.model_group)):
        ranks = [None] * dist.get_world_size(group)
        dist.all_gather_object(ranks, dist.get_rank(), group=group)
        seen[key] = ranks
    full = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    shard = tparallel.ModelShard(model_rank(), model_size(), mesh.model_group)
    got = {}
    for name, split, t in (("packed", tparallel.PACKED, full), ("row", tparallel.ROW, full.T)):
        local = tparallel.shard(t, split, shard.rank, shard.size)
        got[name] = torch.equal(tparallel.gather(local, split, shard), t)
    return {"mesh": tuple(mesh[:4]), "groups": seen, "gathered": got, "data": data_size()}


def test_grid_lays_ranks_out_as_jax_create_mesh():
    """Global rank r at data r // T, model r % T; the model group its T
    consecutive ranks, the data group those of its model rank: JAX's
    `create_mesh(2, 2)` row-major device array."""
    got = run_ranks(_grid_and_gather, 4)
    devices = create_mesh(2, 2, jax.devices()[:4]).devices
    ids = np.vectorize(lambda d: d.id)(devices)
    for r, res in enumerate(got):
        d, m = divmod(r, 2)
        assert res["mesh"] == (d, 2, m, 2) and ids[d, m] == r
        assert res["groups"]["model"] == ids[d].tolist()
        assert res["groups"]["data"] == ids[:, m].tolist()
        assert res["gathered"] == {"packed": True, "row": True} and res["data"] == 2


def test_entry_point_and_trainer_name_a_mesh_that_does_not_fit(monkeypatch, tmp_path):
    """A batch the data axis does not divide raises naming both numbers;
    so does a `mesh.model` that does not divide the world (here one
    process, no group)."""
    from bm2f_tpu_torch.train import __main__ as train_main
    from bm2f_tpu_torch.train.trainer import Trainer
    from torch_port_utils import SMALL

    monkeypatch.setattr(train_main, "world_size", lambda: 4)
    with pytest.raises(ValueError, match=r"over 2 ranks of the data axis \(world 4, "
                                         r"mesh.model 2\)"):
        train_main.main(["--device", "cpu", "--synthetic", "--batch", "3", "--max-iter", "1",
                         "--output", str(tmp_path), "--set", "mesh.model=2"])
    with pytest.raises(ValueError, match="mesh.model=2 does not divide the world of 1 ranks"):
        Trainer(get_config("coco_instance_r50", {**SMALL, "mesh.model": 2}), device="cpu")
