"""Dataset mappers: raw dataset dicts -> fixed-shape model inputs.

Reference equivalents (mask2former/data/dataset_mappers/*.py):
- COCOInstanceNewBaselineDatasetMapper (LSJ)        -> `coco_instance_lsj`
- COCOPanopticNewBaselineDatasetMapper (LSJ)        -> `coco_panoptic_lsj`
- MaskFormerSemanticDatasetMapper                   -> `mask_former_semantic`
- MaskFormerPanopticDatasetMapper                   -> `mask_former_panoptic`
- MaskFormerInstanceDatasetMapper                   -> `mask_former_instance`

The port's copy of the JAX package's mappers (numpy and Pillow); the video
mappers (`ytvis`, `ytvis_with_feats`, `coco_clip`) live in `data/ytvis.py`. Every mapper emits static shapes — image
(S, S, 3) or pad-to-divisibility buckets, targets padded to
`max_instances` with a validity mask — as the JAX train step needs, and
the port's eval pads to the same buckets.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from bm2f_tpu_torch.config import InputConfig
from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
from bm2f_tpu_torch.data.transforms import (
    color_aug_ssd,
    lsj_transform,
    shortest_edge_transform,
)


def read_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _pad_targets(labels, masks, max_instances: int, h: int, w: int):
    G = max_instances
    out_labels = np.full((G,), -1, np.int32)
    out_masks = np.zeros((G, h, w), np.float32)
    out_valid = np.zeros((G,), bool)
    n = min(len(labels), G)
    if n > 0:
        out_labels[:n] = labels[:n]
        out_masks[:n] = masks[:n]
        out_valid[:n] = True
    return out_labels, out_masks, out_valid


class COCOInstanceLSJMapper:
    """LSJ train mapper (reference:
    coco_instance_new_baseline_dataset_mapper.py:37-66): RandomFlip +
    ResizeScale(0.1, 2.0) + FixedSizeCrop(image_size^2); instances whose
    mask becomes empty are dropped."""

    def __init__(self, cfg: InputConfig, is_train: bool = True, seed: int = 0):
        self.cfg = cfg
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)

    def __call__(self, dd: Dict) -> Optional[Dict]:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        h, w = img.shape[:2]
        S = self.cfg.image_size
        t = lsj_transform(
            self.rng, h, w, S, self.cfg.min_scale, self.cfg.max_scale
        )
        image = t.apply_image(img).astype(np.float32)

        labels, masks = [], []
        for ann in dd.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            m = segmentation_to_mask(ann["segmentation"], h, w)
            m = t.apply_mask(m)
            if m.sum() == 0:
                continue
            labels.append(ann["category_id"])
            masks.append(m.astype(np.float32))
        labels = np.asarray(labels, np.int32)
        masks = (
            np.stack(masks) if masks else np.zeros((0, S, S), np.float32)
        )
        L, M, V = _pad_targets(labels, masks, self.cfg.max_instances, S, S)
        return {"images": image, "labels": L, "masks": M, "valid": V}


class COCOPanopticLSJMapper:
    """LSJ panoptic train mapper (reference:
    coco_panoptic_new_baseline_dataset_mapper.py): targets come from the
    panoptic png (id map) + segments_info."""

    def __init__(self, cfg: InputConfig, is_train: bool = True, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def __call__(self, dd: Dict) -> Optional[Dict]:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        h, w = img.shape[:2]
        S = self.cfg.image_size
        t = lsj_transform(self.rng, h, w, S, self.cfg.min_scale, self.cfg.max_scale)
        image = t.apply_image(img).astype(np.float32)

        pan = dd.get("pan_seg")
        if pan is None:
            from bm2f_tpu_torch.data.panoptic_io import read_panoptic_png

            pan = read_panoptic_png(dd["pan_seg_file_name"])
        pan_t = t.apply_mask(pan.astype(np.uint32))

        labels, masks = [], []
        for seg in dd["segments_info"]:
            if seg.get("iscrowd", 0):
                continue
            m = (pan_t == seg["id"]).astype(np.float32)
            if m.sum() == 0:
                continue
            labels.append(seg["category_id"])
            masks.append(m)
        labels = np.asarray(labels, np.int32)
        masks = np.stack(masks) if masks else np.zeros((0, S, S), np.float32)
        L, M, V = _pad_targets(labels, masks, self.cfg.max_instances, S, S)
        return {"images": image, "labels": L, "masks": M, "valid": V}


class MaskFormerSemanticMapper:
    """Semantic train mapper (reference:
    mask_former_semantic_dataset_mapper.py:61-84): ResizeShortestEdge +
    crop + ColorAugSSD + flip; the semantic map becomes per-class binary
    masks (one target per class present, like MaskFormer training)."""

    def __init__(
        self,
        cfg: InputConfig,
        is_train: bool = True,
        seed: int = 0,
        short_edge_choices=None,
        ignore_label: int = 255,
        single_category_max_area: float = 1.0,
    ):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        # MIN_SIZE_TRAIN "choice" sampling comes from the config (e.g.
        # Base-ADE20K yaml:37 [int(x*0.1*512) for x in range(5,21)]);
        # an explicit argument overrides (tests)
        if short_edge_choices is None:
            short_edge_choices = (
                getattr(cfg, "short_edge_choices", ()) or (cfg.image_size,)
            )
        self.short_edge_choices = short_edge_choices
        self.max_size = getattr(cfg, "max_size_train", 2048)
        # crops may be rectangular (Cityscapes semantic: (512, 1024))
        self.crop_hw = (cfg.image_size,
                        getattr(cfg, "crop_width", 0) or cfg.image_size)
        self.ignore_label = ignore_label
        # reference: INPUT.CROP.SINGLE_CATEGORY_MAX_AREA (config.py:16-18) —
        # retry random crops until no single category dominates
        self.single_category_max_area = single_category_max_area

    def _transform_with_category_constraint(self, h, w, sem):
        for _ in range(10):
            t = shortest_edge_transform(
                self.rng, h, w, self.short_edge_choices,
                max_size=self.max_size,
                crop_size=self.crop_hw, fixed_pad=self.crop_hw,
            )
            if self.single_category_max_area >= 1.0:
                return t
            sem_t = t.apply_segmap(sem, self.ignore_label)
            labels, counts = np.unique(sem_t, return_counts=True)
            counts = counts[labels != self.ignore_label]
            if len(counts) == 0:
                continue
            if counts.max() <= self.single_category_max_area * sem_t.size:
                return t
        return t

    def __call__(self, dd: Dict) -> Optional[Dict]:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        sem = dd.get("sem_seg")
        if sem is None:
            with Image.open(dd["sem_seg_file_name"]) as im:
                sem = np.asarray(im).astype(np.int32)
        h, w = img.shape[:2]
        S, SW = self.crop_hw
        t = self._transform_with_category_constraint(h, w, sem)
        if self.cfg.color_aug_ssd:
            img = color_aug_ssd(self.rng, img)
        image = t.apply_image(img).astype(np.float32)
        sem_t = t.apply_segmap(sem, self.ignore_label)

        classes = np.unique(sem_t)
        classes = classes[classes != self.ignore_label]
        labels = classes.astype(np.int32)
        masks = np.stack(
            [(sem_t == c).astype(np.float32) for c in classes]
        ) if len(classes) else np.zeros((0, S, SW), np.float32)
        L, M, V = _pad_targets(labels, masks, self.cfg.max_instances, S, SW)
        return {
            "images": image,
            "labels": L,
            "masks": M,
            "valid": V,
            "sem_seg": sem_t.astype(np.int32),
        }


class MaskFormerPanopticMapper(MaskFormerSemanticMapper):
    """Panoptic variant (reference: mask_former_panoptic_dataset_mapper.py):
    same augs as semantic, targets from pan_seg segments."""

    def __call__(self, dd: Dict) -> Optional[Dict]:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        h, w = img.shape[:2]
        S, SW = self.crop_hw
        t = shortest_edge_transform(
            self.rng, h, w, self.short_edge_choices,
            max_size=self.max_size,
            crop_size=self.crop_hw, fixed_pad=self.crop_hw,
        )
        if self.cfg.color_aug_ssd:
            img = color_aug_ssd(self.rng, img)
        image = t.apply_image(img).astype(np.float32)

        pan = dd.get("pan_seg")
        if pan is None:
            from bm2f_tpu_torch.data.panoptic_io import read_panoptic_png

            pan = read_panoptic_png(dd["pan_seg_file_name"])
        pan_t = t.apply_mask(pan.astype(np.uint32))
        labels, masks = [], []
        for seg in dd["segments_info"]:
            if seg.get("iscrowd", 0):
                continue
            m = (pan_t == seg["id"]).astype(np.float32)
            if m.sum() == 0:
                continue
            labels.append(seg["category_id"])
            masks.append(m)
        labels = np.asarray(labels, np.int32)
        masks = np.stack(masks) if masks else np.zeros((0, S, SW), np.float32)
        L, M, V = _pad_targets(labels, masks, self.cfg.max_instances, S, SW)
        return {"images": image, "labels": L, "masks": M, "valid": V}


class MaskFormerInstanceMapper:
    """Instance train mapper with ResizeShortestEdge augs (reference:
    mask_former_instance_dataset_mapper.py)."""

    def __init__(self, cfg: InputConfig, is_train=True, seed=0,
                 short_edge_choices=None):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        if short_edge_choices is None:
            short_edge_choices = (
                getattr(cfg, "short_edge_choices", ()) or (cfg.image_size,)
            )
        self.short_edge_choices = short_edge_choices
        self.max_size = getattr(cfg, "max_size_train", 2048)
        self.crop_hw = (cfg.image_size,
                        getattr(cfg, "crop_width", 0) or cfg.image_size)

    def __call__(self, dd: Dict) -> Optional[Dict]:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        h, w = img.shape[:2]
        S = self.cfg.image_size
        t = shortest_edge_transform(
            self.rng, h, w, self.short_edge_choices,
            max_size=self.max_size,
            crop_size=self.crop_hw, fixed_pad=self.crop_hw,
        )
        image = t.apply_image(img).astype(np.float32)
        labels, masks = [], []
        for ann in dd.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            m = segmentation_to_mask(ann["segmentation"], h, w)
            m = t.apply_mask(m)
            if m.sum() == 0:
                continue
            labels.append(ann["category_id"])
            masks.append(m.astype(np.float32))
        labels = np.asarray(labels, np.int32)
        SW = self.crop_hw[1]
        masks = np.stack(masks) if masks else np.zeros((0, S, SW), np.float32)
        L, M, V = _pad_targets(labels, masks, self.cfg.max_instances, S, SW)
        return {"images": image, "labels": L, "masks": M, "valid": V}


class EvalMapper:
    """Eval-time mapper: resize shortest edge (no flip/crop), pad to the
    smallest of a few size buckets so eval batches are static-shape without
    padding every image to the global max (a single 1344 bucket wastes up to
    ~2.8x compute on 800x600 COCO images); one XLA compile per bucket,
    bounded by len(buckets). Records the original size for
    sem_seg_postprocess."""

    def __init__(self, short_edge: int = 800, max_size: int = 1333,
                 bucket=(704, 960, 1344),
                 pad_value: Tuple[float, ...] = (123.675, 116.28, 103.53)):
        self.short_edge = short_edge
        self.max_size = max_size
        self.buckets = tuple(sorted(
            (bucket,) if isinstance(bucket, int) else tuple(bucket)
        ))
        # The reference pads the NORMALIZED tensor with zeros (= mean pixel in
        # raw space, detectron2 ImageList semantics); padding raw pixels with 0
        # would be ~-2 sigma after normalization and shifts border conv
        # activations (ADVICE round 1).
        self.pad_value = np.asarray(pad_value, np.float32)

    def __call__(self, dd: Dict) -> Dict:
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        h, w = img.shape[:2]
        scale = self.short_edge / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        from bm2f_tpu_torch.data.transforms import resize_image

        B = next((b for b in self.buckets if b >= max(nh, nw)),
                 self.buckets[-1])
        if max(nh, nw) > B:
            # only reachable with a custom bucket list whose top bucket is
            # below ceil(max_size/32)*32 (eval.bucket_ladder always covers
            # it): shrink to fit, and say so — this deviates from the
            # reference's ResizeShortestEdge+MAX_SIZE_TEST protocol
            s2 = B / max(nh, nw)
            nh, nw = int(nh * s2), int(nw * s2)
            # stderr, not stdout: bench-style harnesses parse stdout lines
            # as JSON and a stray WARNING line would break them
            print(f"WARNING: EvalMapper shrink-to-fit: image "
                  f"{h}x{w} -> {nh}x{nw} exceeds the largest bucket {B}; "
                  f"evaluating below the reference test resolution",
                  file=sys.stderr)
        image = resize_image(img, nh, nw).astype(np.float32)
        full = np.broadcast_to(self.pad_value, (B, B, 3)).copy()
        full[:nh, :nw] = image
        image = full
        return {
            "images": image,
            "image_id": dd.get("image_id", -1),
            "orig_hw": (h, w),
            "resized_hw": (nh, nw),
        }


class _LazyMappers(dict):
    """The video mappers resolve on first use: `data/ytvis.py` imports this
    module."""

    def __missing__(self, key):
        from bm2f_tpu_torch.data.ytvis import (
            CocoClipDatasetMapper,
            YTVISDatasetMapper,
            YTVISDatasetWithFeatsMapper,
        )

        self.update({"ytvis": YTVISDatasetMapper,
                     "ytvis_with_feats": YTVISDatasetWithFeatsMapper,
                     "coco_clip": CocoClipDatasetMapper})
        return dict.__getitem__(self, key)


MAPPERS = _LazyMappers({
    "coco_instance_lsj": COCOInstanceLSJMapper,
    "coco_panoptic_lsj": COCOPanopticLSJMapper,
    "mask_former_semantic": MaskFormerSemanticMapper,
    "mask_former_panoptic": MaskFormerPanopticMapper,
    "mask_former_instance": MaskFormerInstanceMapper,
})
