"""YouTube-VIS loading and mappers (reference:
mask2former_video/data_video/datasets/ytvis.py:271 register_ytvis_instances,
dataset_mapper.py:114 YTVISDatasetMapper, dataset_mapper_w_feat.py:127
YTVISDatasetWithFeatsMapper, builtin.py:13-40 splits): the port's copy of
the JAX package's `data/ytvis.py`, numpy and Pillow on the host.

Frame sampling follows the reference (dataset_mapper.py:188-202): a random
reference frame, num_frames-1 more within +-sampling_frame_range, sorted
(optionally shuffled). Instances are aligned across frames by annotation id,
with all-zero masks where an object is absent; crowd tracks are dropped.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from bm2f_tpu_torch.config import InputConfig
from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from bm2f_tpu_torch.data.mappers import COCOInstanceLSJMapper, read_image
from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
from bm2f_tpu_torch.data.transforms import shortest_edge_transform
from bm2f_tpu_torch.ops.interpolate import resize_bilinear

# DINOv2 ViT-S/14 patch features, the reference's width
DINO_CHANNELS = 384


def load_ytvis_json(json_file: str, image_root: str,
                    dataset_name: Optional[str] = None) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name:
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
        )

    anns_by_vid = defaultdict(list)
    for ann in data.get("annotations", []):
        anns_by_vid[ann["video_id"]].append(ann)

    out = []
    for vid in data["videos"]:
        length = len(vid["file_names"])
        anns = []
        for a in anns_by_vid.get(vid["id"], []):
            anns.append({
                "id": a["id"],
                "category_id": id_map.get(a["category_id"], a["category_id"]),
                "segmentations": a.get("segmentations", [None] * length),
                "bboxes": a.get("bboxes", [None] * length),
                "iscrowd": a.get("iscrowd", 0),
            })
        out.append({
            "video_id": vid["id"],
            "height": vid["height"],
            "width": vid["width"],
            "length": length,
            "file_names": [os.path.join(image_root, f) for f in vid["file_names"]],
            "annotations": anns,
        })
    return out


def register_ytvis_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_ytvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root,
                                  evaluator_type="ytvis")


# name: (json file, frame root) under the datasets root (reference builtin.py)
YTVIS_SPLITS = {
    "ytvis_2019_train": ("ytvis_2019/train.json", "ytvis_2019/train/JPEGImages"),
    "ytvis_2019_val": ("ytvis_2019/valid.json", "ytvis_2019/valid/JPEGImages"),
    "ytvis_2021_train": ("ytvis_2021/train.json", "ytvis_2021/train/JPEGImages"),
    "ytvis_2021_val": ("ytvis_2021/valid.json", "ytvis_2021/valid/JPEGImages"),
    # mini splits (reference builtin.py:35-40)
    "ytvis_2021_train_mini": ("ytvis_2021/train_mini.json", "ytvis_2021/train/JPEGImages"),
    "ytvis_2021_val_mini": ("ytvis_2021/valid_mini.json", "ytvis_2021/valid/JPEGImages"),
}


def register_all_ytvis(root: Optional[str] = None, force: bool = False) -> None:
    """Registers each split whose json exists under `root` (else
    `$DETECTRON2_DATASETS`, else ./datasets) and is not registered yet;
    `force` registers it again (a test's or a run's own root)."""
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    if force:
        DatasetCatalog.allow_overwrite = True
    for name, (jf, ir) in YTVIS_SPLITS.items():
        jf, ir = os.path.join(root, jf), os.path.join(root, ir)
        if os.path.exists(jf) and (force or name not in DatasetCatalog):
            register_ytvis_instances(name, jf, ir)


class YTVISDatasetMapper:
    """Train mapper: video dict -> fixed-shape clip sample
    {"images": (T, S, S, 3), "labels": (G,), "masks": (G, T, S, S), "valid":
    (G,)}."""

    def __init__(self, cfg: InputConfig, is_train: bool = True, seed: int = 0,
                 short_edge_choices=(360, 480)):
        self.cfg = cfg
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        self.short_edge_choices = short_edge_choices

    def _sample_frames(self, length: int) -> List[int]:
        T = self.cfg.sampling_frame_num
        if not self.is_train:
            return list(range(length))
        ref = self.rng.randint(length)
        lo = max(0, ref - self.cfg.sampling_frame_range)
        hi = min(length, ref + self.cfg.sampling_frame_range + 1)
        pool = [i for i in range(lo, hi) if i != ref]
        picks = self.rng.choice(
            pool, min(T - 1, len(pool)), replace=False).tolist() if pool else []
        while len(picks) < T - 1:
            picks.append(ref)
        frames = sorted(picks + [ref])
        if self.cfg.sampling_frame_shuffle:
            self.rng.shuffle(frames)
        return frames

    def __call__(self, dd: Dict) -> Optional[Dict]:
        frames = self._sample_frames(dd["length"])
        h, w = dd["height"], dd["width"]
        S = self.cfg.image_size
        # one transform for every frame of the clip (reference augmentation.py)
        t = shortest_edge_transform(
            self.rng, h, w, self.short_edge_choices,
            crop_size=(S, S) if self.is_train else None, fixed_pad=(S, S))

        images = []
        for fi in frames:
            img = dd.get("images", {}).get(fi) if isinstance(dd.get("images"), dict) else None
            if img is None:
                img = read_image(dd["file_names"][fi])
            images.append(t.apply_image(img).astype(np.float32))
        images = np.stack(images)  # (T, S, S, 3)

        T = len(frames)
        labels, masks = [], []
        for ann in dd.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            per_frame = []
            any_present = False
            for fi in frames:
                seg = ann["segmentations"][fi]
                if seg is None:
                    per_frame.append(np.zeros((S, S), np.float32))
                else:
                    m = t.apply_mask(segmentation_to_mask(seg, h, w)).astype(np.float32)
                    any_present = any_present or m.sum() > 0
                    per_frame.append(m)
            if not any_present:
                continue
            labels.append(ann["category_id"])
            masks.append(np.stack(per_frame))
        labels = np.asarray(labels, np.int32)
        masks = np.stack(masks) if masks else np.zeros((0, T, S, S), np.float32)

        G = self.cfg.max_instances
        L = np.full((G,), -1, np.int32)
        M = np.zeros((G, T, S, S), np.float32)
        V = np.zeros((G,), bool)
        n = min(len(labels), G)
        if n:
            L[:n], M[:n], V[:n] = labels[:n], masks[:n], True
        return {"images": images, "labels": L, "masks": M, "valid": V,
                "video_id": dd.get("video_id", -1)}


class CocoClipDatasetMapper:
    """Pseudo-video from COCO: one image replicated T times (reference:
    dataset_mapper.py:293 CocoClipDatasetMapper, for joint training)."""

    def __init__(self, cfg: InputConfig, is_train: bool = True, seed: int = 0):
        self.inner = COCOInstanceLSJMapper(cfg, is_train, seed)
        self.T = cfg.sampling_frame_num

    def __call__(self, dd: Dict) -> Optional[Dict]:
        s = self.inner(dd)
        if s is None:
            return None
        return {
            "images": np.repeat(s["images"][None], self.T, 0),
            "labels": s["labels"],
            "masks": np.repeat(s["masks"][:, None], self.T, 1),
            "valid": s["valid"],
            "video_id": dd.get("image_id", -1),
        }


def resize_patch_grid(f: np.ndarray, hp: int, wp: int) -> np.ndarray:
    """(H, W, C) patch features bilinearly resized to (hp, wp), with the
    model's resize (`ops.resize_bilinear`) on the host."""
    x = torch.from_numpy(np.ascontiguousarray(f, np.float32)).permute(2, 0, 1)
    return resize_bilinear(x, hp, wp).permute(1, 2, 0).numpy()


class YTVISDatasetWithFeatsMapper(YTVISDatasetMapper):
    """Train mapper that also loads each frame's precomputed DINOv2 patch
    features (reference: dataset_mapper_w_feat.py:127, :250-267; selected
    when the sup_type holds temporal pairwise, train_net_video.py:82-85).

    Features are read from `feats_root/<video>/<frame>.npy` (numpy) or
    `.pt` (torch), as (Hp, Wp, C) grids or (N, C) tokens of a square grid,
    and bilinearly resized to `patch_grid`; emitted as "dino_feats" (T, Hp,
    Wp, C). Without `feats_root`, or for a frame without a file, the grid is
    zeros (C = 384), as the JAX mapper does."""

    def __init__(self, cfg, is_train=True, seed=0, short_edge_choices=(360, 480),
                 feats_root: str = "", patch_grid=(16, 16)):
        super().__init__(cfg, is_train, seed, short_edge_choices)
        self.feats_root = feats_root
        self.patch_grid = patch_grid

    def _load_feat(self, file_name: str):
        stem = os.path.splitext(os.path.basename(file_name))[0]
        vid = os.path.basename(os.path.dirname(file_name))
        for ext, loader in ((".npy", np.load), (".pt", self._load_pt)):
            p = os.path.join(self.feats_root, vid, stem + ext)
            if os.path.exists(p):
                return loader(p)
        return None

    @staticmethod
    def _load_pt(p):
        t = torch.load(p, map_location="cpu", weights_only=False)
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)

    def __call__(self, dd):
        sample = super().__call__(dd)
        if sample is None:
            return None
        Hp, Wp = self.patch_grid
        feats = []
        T = sample["images"].shape[0]
        C = None
        for fi in range(T):
            f = None
            if self.feats_root:
                f = self._load_feat(dd["file_names"][min(fi, len(dd["file_names"]) - 1)])
            if f is None:
                if C is None:
                    C = DINO_CHANNELS
                f = np.zeros((Hp, Wp, C), np.float32)
            else:
                if f.ndim == 2:  # (N, C) patch tokens
                    g = int(round(f.shape[0] ** 0.5))
                    f = f.reshape(g, g, -1)
                C = f.shape[-1]
                if f.shape[:2] != (Hp, Wp):
                    f = resize_patch_grid(f, Hp, Wp)
            feats.append(f.astype(np.float32))
        sample["dino_feats"] = np.stack(feats)
        return sample
