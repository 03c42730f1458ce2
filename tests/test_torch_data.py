"""The port's data layer (copies of the JAX package's numpy and Pillow
modules) against the JAX package's on the same seeded inputs, bitwise: the
mask codec, rasterization, the panoptic PNG, the transforms, every mapper,
the loaders and their sharding by rank, and the dataset registrations on a
synthetic COCO-format dataset (`bm2f_tpu_torch.data.synthetic`)."""

import numpy as np
import pytest

from bm2f_tpu.config import InputConfig as JaxInputConfig
from bm2f_tpu.data import catalog as jax_catalog
from bm2f_tpu.data import loader as jax_loader
from bm2f_tpu.data import mappers as jax_mappers
from bm2f_tpu.data import mask_ops as jax_mask_ops
from bm2f_tpu.data import panoptic_io as jax_panoptic_io
from bm2f_tpu.data import transforms as jax_transforms
from bm2f_tpu.data.datasets import register_all_builtin_datasets as jax_register
from bm2f_tpu_torch.config import InputConfig
from bm2f_tpu_torch.data import catalog, loader, mappers, mask_ops, panoptic_io, transforms
from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
from bm2f_tpu_torch.data.synthetic import THINGS, write_synthetic_coco


def same_tree(a, b):
    """Equal structure, equal values and dtypes (arrays bitwise)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


SHAPES = [(1, 1), (7, 5), (37, 53), (120, 97)]


@pytest.mark.parametrize("shape", SHAPES)
def test_rle_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    for density in (0.0, 0.3, 0.9, 1.0):
        m = (rng.rand(*shape) < density).astype(np.uint8)
        rle = mask_ops.rle_encode(m)
        assert rle == jax_mask_ops.rle_encode(m)
        same_tree(mask_ops.rle_decode(rle), jax_mask_ops.rle_decode(rle))
        np.testing.assert_array_equal(mask_ops.rle_decode(rle), m)
        counts = rle["counts"].encode("ascii")
        assert (mask_ops._decode_compressed_counts(counts)
                == jax_mask_ops._decode_compressed_counts(counts))
        uncompressed = {"size": list(shape),
                        "counts": mask_ops._decode_compressed_counts(counts)}
        same_tree(mask_ops.rle_decode(uncompressed), jax_mask_ops.rle_decode(uncompressed))


@pytest.mark.parametrize("kind", ["polygon", "rle", "uncompressed_rle"])
def test_segmentation_to_mask_matches_jax(kind):
    rng = np.random.RandomState(3)
    h, w = 61, 83
    if kind == "polygon":
        seg = [rng.uniform(0, 80, 10).tolist(), [5, 5, 30, 8, 20, 40], [1, 1, 2, 2]]
    else:
        seg = mask_ops.rle_encode((rng.rand(h, w) > 0.5).astype(np.uint8))
        if kind == "uncompressed_rle":
            seg = {"size": seg["size"], "counts":
                   mask_ops._decode_compressed_counts(seg["counts"].encode("ascii"))}
    ours = mask_ops.segmentation_to_mask(seg, h, w)
    same_tree(ours, jax_mask_ops.segmentation_to_mask(seg, h, w))
    same_tree(mask_ops.mask_to_box(ours), jax_mask_ops.mask_to_box(ours))
    assert mask_ops.mask_area(ours) == jax_mask_ops.mask_area(ours)
    other = mask_ops.rle_encode(np.roll(ours, 3, axis=1))
    a = mask_ops.rle_encode(ours)
    for crowd in (False, True):
        assert mask_ops.rle_iou(a, other, crowd) == jax_mask_ops.rle_iou(a, other, crowd)


def test_panoptic_png_round_trip_across_packages(tmp_path):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256 ** 3, (45, 67)).astype(np.int64)
    panoptic_io.write_panoptic_png(str(tmp_path / "a.png"), ids)
    jax_panoptic_io.write_panoptic_png(str(tmp_path / "b.png"), ids)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    ours = panoptic_io.read_panoptic_png(str(tmp_path / "b.png"))
    same_tree(ours, jax_panoptic_io.read_panoptic_png(str(tmp_path / "a.png")))
    np.testing.assert_array_equal(ours, ids)


# downscale, upscale and odd sizes, (in_h, in_w) -> (out_h, out_w)
RESIZES = [((480, 640), (800, 1067)), ((427, 640), (339, 508)), ((33, 17), (7, 61)),
           ((5, 5), (5, 5)), ((101, 99), (250, 3))]


@pytest.mark.parametrize("sizes", RESIZES)
def test_resizes_match_jax(sizes):
    (h, w), (oh, ow) = sizes
    rng = np.random.RandomState(h)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    seg = rng.randint(0, 300, (h, w)).astype(np.int32)
    same_tree(transforms.resize_image(img, oh, ow), jax_transforms.resize_image(img, oh, ow))
    same_tree(transforms.resize_mask(seg.astype(np.uint8), oh, ow),
              jax_transforms.resize_mask(seg.astype(np.uint8), oh, ow))
    x = rng.randn(3, h, w).astype(np.float32)
    same_tree(transforms.resize_bilinear_np(x, oh, ow),
              jax_transforms.resize_bilinear_np(x, oh, ow))


@pytest.mark.parametrize("seed", range(4))
def test_geometric_transforms_match_jax(seed):
    rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
    h, w = 90 + 7 * seed, 130 - 9 * seed
    img = rng_a.randint(0, 256, (h, w, 3)).astype(np.uint8)
    rng_b.randint(0, 256, (h, w, 3))
    seg = (img[..., 0] % 7).astype(np.int32)
    for _ in range(3):
        a = transforms.lsj_transform(rng_a, h, w, 96, 0.3, 1.7)
        b = jax_transforms.lsj_transform(rng_b, h, w, 96, 0.3, 1.7)
        assert (a.resize_hw, a.crop_yx, a.crop_hw, a.flip, a.pad_hw) == (
            b.resize_hw, b.crop_yx, b.crop_hw, b.flip, b.pad_hw)
        same_tree(a.apply_image(img), b.apply_image(img))
        same_tree(a.apply_mask(seg.astype(np.uint8)), b.apply_mask(seg.astype(np.uint8)))
        same_tree(a.apply_segmap(seg), b.apply_segmap(seg))
        a = transforms.shortest_edge_transform(rng_a, h, w, (64, 80, 96), max_size=160,
                                               crop_size=(72, 88))
        b = jax_transforms.shortest_edge_transform(rng_b, h, w, (64, 80, 96), max_size=160,
                                                   crop_size=(72, 88))
        same_tree(a.apply_image(img, 0.0), b.apply_image(img, 0.0))
        same_tree(transforms.color_aug_ssd(rng_a, img), jax_transforms.color_aug_ssd(rng_b, img))


def _instance_dict(rng, h, w, i):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    anns = []
    for g in range(4):
        x0, y0 = rng.randint(0, w - 20), rng.randint(0, h - 20)
        poly = [[x0, y0, x0 + 18, y0, x0 + 18, y0 + 15, x0, y0 + 15]]
        seg = poly if g % 2 else mask_ops.rle_encode(
            (rng.rand(h, w) > 0.7).astype(np.uint8))
        anns.append({"category_id": int(rng.randint(0, 5)), "segmentation": seg,
                     "iscrowd": int(g == 3), "bbox": [x0, y0, 18, 15]})
    pan = np.zeros((h, w), np.uint32)
    pan[: h // 2] = 1
    pan[h // 2:, : w // 2] = 2
    sem = rng.randint(0, 5, (h, w)).astype(np.int32)
    sem[:3] = 255
    return {"image": img, "image_id": i, "height": h, "width": w, "annotations": anns,
            "pan_seg": pan, "sem_seg": sem,
            "segments_info": [{"id": 1, "category_id": 2, "iscrowd": 0},
                              {"id": 2, "category_id": 4, "iscrowd": 0}]}


@pytest.mark.parametrize("name", ["coco_instance_lsj", "coco_panoptic_lsj",
                                  "mask_former_semantic", "mask_former_panoptic",
                                  "mask_former_instance"])
def test_train_mappers_match_jax(name):
    kw = dict(image_size=64, max_instances=6, min_scale=0.5, max_scale=1.5,
              short_edge_choices=(48, 64, 80), max_size_train=128, color_aug_ssd=True)
    ours = mappers.MAPPERS[name](InputConfig(**kw), seed=7)
    ref = jax_mappers.MAPPERS[name](JaxInputConfig(**kw), seed=7)
    rng = np.random.RandomState(1)
    for i, (h, w) in enumerate(((70, 90), (96, 64), (51, 77))):
        dd = _instance_dict(rng, h, w, i)
        same_tree(ours(dict(dd)), ref(dict(dd)))


@pytest.mark.parametrize("name", ["ytvis", "ytvis_with_feats", "coco_clip"])
def test_video_mappers_raise_until_ported(name):
    """Ported: each name gives the port's video mapper (held against the JAX
    package's in tests/test_torch_ytvis.py)."""
    from bm2f_tpu_torch.data import ytvis

    cls = {"ytvis": ytvis.YTVISDatasetMapper,
           "ytvis_with_feats": ytvis.YTVISDatasetWithFeatsMapper,
           "coco_clip": ytvis.CocoClipDatasetMapper}[name]
    assert mappers.MAPPERS[name] is cls
    assert isinstance(mappers.MAPPERS[name](InputConfig(), seed=0), cls)


# (H, W) at COCO-like aspect ratios; each lands in its bucket of (160, 224, 320)
EVAL_SIZES = [(96, 128), (128, 96), (100, 100), (60, 200), (150, 113), (31, 300)]


@pytest.mark.parametrize("hw", EVAL_SIZES)
def test_eval_mapper_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    dd = {"image": rng.randint(0, 256, (*hw, 3)).astype(np.uint8), "image_id": 5}
    for short_edge, max_size, bucket in ((160, 320, (160, 224, 320)), (96, 160, 160)):
        kw = dict(short_edge=short_edge, max_size=max_size, bucket=bucket,
                  pad_value=(123.675, 116.28, 103.53))
        same_tree(mappers.EvalMapper(**kw)(dd), jax_mappers.EvalMapper(**kw)(dd))


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    names = write_synthetic_coco(str(root), sizes=((48, 64), (64, 48), (40, 40)), seed=2)
    register_all_builtin_datasets(str(root), force=True)
    jax_register(str(root), force=True)
    return root, names


def test_registration_matches_jax(synthetic_root):
    _, names = synthetic_root
    for name, etype in names.items():
        ours = catalog.DatasetCatalog.get(name)
        same_tree(ours, jax_catalog.DatasetCatalog.get(name))
        meta = catalog.MetadataCatalog.get(name).as_dict()
        assert meta == jax_catalog.MetadataCatalog.get(name).as_dict()
        assert meta["evaluator_type"] == etype and len(ours) == 3


def test_synthetic_dataset_is_consistent(synthetic_root):
    """The instance masks are the panoptic PNG's thing segments, crowd ones
    flagged; the semantic PNG is the panoptic map's classes, void 255."""
    inst = {d["image_id"]: d for d in catalog.DatasetCatalog.get("coco_2017_val")}
    for pd in catalog.DatasetCatalog.get("coco_2017_val_panoptic"):
        pan = panoptic_io.read_panoptic_png(pd["pan_seg_file_name"])
        h, w = pan.shape
        things = [s for s in pd["segments_info"] if s["isthing"]]
        anns = inst[pd["image_id"]]["annotations"]
        assert len(anns) == len(things) and any(a["iscrowd"] for a in anns)
        for s, a in zip(things, anns):
            np.testing.assert_array_equal(mask_ops.segmentation_to_mask(a["segmentation"], h, w),
                                          pan == s["id"])
            assert (a["category_id"], a["iscrowd"]) == (s["category_id"], s["iscrowd"])
            assert s["category_id"] < THINGS
    for sd in catalog.DatasetCatalog.get("ade20k_sem_seg_val"):
        from PIL import Image

        sem = np.asarray(Image.open(sd["sem_seg_file_name"]))
        assert (sem[0] == 255).all() and (sem[sem != 255] < 8).all()


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loaders_and_sharding_match_jax(synthetic_root, world):
    name = "coco_2017_val"
    for rank in range(world):
        assert (list(loader.InferenceSampler(11, rank, world).indices)
                == list(jax_loader.InferenceSampler(11, rank, world).indices))
        ours = iter(loader.TrainingSampler(9, seed=3, rank=rank, world_size=world))
        ref = iter(jax_loader.TrainingSampler(9, seed=3, rank=rank, world_size=world))
        assert [next(ours) for _ in range(12)] == [next(ref) for _ in range(12)]
        kw = dict(short_edge=48, max_size=64, bucket=(48, 64), pad_value=(0.0, 0.0, 0.0))
        ours = list(loader.build_test_loader(name, mappers.EvalMapper(**kw),
                                             rank=rank, world_size=world))
        ref = list(jax_loader.build_test_loader(name, jax_mappers.EvalMapper(**kw),
                                                rank=rank, world_size=world))
        same_tree(ours, ref)
    cfg = dict(image_size=48, max_instances=4)
    ours = loader.build_train_loader(name, mappers.COCOInstanceLSJMapper(InputConfig(**cfg)),
                                     batch_size=2, seed=1, rank=world - 1, world_size=world)
    ref = jax_loader.build_train_loader(
        name, jax_mappers.COCOInstanceLSJMapper(JaxInputConfig(**cfg)), batch_size=2,
        seed=1, rank=world - 1, world_size=world)
    for _ in range(2):
        same_tree(next(ours), next(ref))
    samples = [{"a": np.ones(2), "b": 3, "c": (1, 2)}, {"a": np.zeros(2), "b": 4, "c": (3, 4)}]
    same_tree(loader.collate(samples), jax_loader.collate(samples))
