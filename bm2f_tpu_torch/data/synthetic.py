"""A seeded synthetic dataset in the COCO formats, laid out as the builtin
registrations expect it under `$DETECTRON2_DATASETS`
(`data/datasets/builtin.py`), so that the eval runs end to end with no
download:

  coco/val2017/<id>.jpg                        images
  coco/annotations/instances_val2017.json      instances: compressed RLE
                                               masks, and one crowd region
                                               an image (uncompressed RLE)
  coco/annotations/panoptic_val2017.json       panoptic segments_info
  coco/panoptic_val2017/<id>.png               panoptic id PNGs
  ADEChallengeData2016/images/validation/<id>.jpg
  ADEChallengeData2016/annotations_detectron2/validation/<id>.png
                                               semantic labels, 255 ignored

which registers `coco_2017_val` (evaluator "coco"), `coco_2017_val_panoptic`
("coco_panoptic_seg") and `ade20k_sem_seg_val` ("sem_seg"). Images are
JPEG because the panoptic and ADE20K layouts name them `.jpg`
(`data/coco.py` maps a panoptic PNG's name to its image's).
`write_predicted_instances` writes a `coco_2017_val` whose instances are a
model's own predictions, for checks whose AP must depend on the weights.

Each image holds a few rectangles and ellipses: `THINGS` thing classes
(instances) over `STUFF` stuff classes, one thing region marked crowd, a
void strip along the top (panoptic id 0, semantic 255). Pixels are a colour
per segment plus noise.

`write_synthetic_ytvis` writes a YouTube-VIS split in the same way, under the
names `data/ytvis.py` registers (`YTVIS_SPLITS`):

  ytvis_2019/valid.json                        videos, per-frame RLE
                                               `segmentations` (null where
                                               an object is absent), one
                                               crowd track a video
  ytvis_2019/valid/JPEGImages/<video>/<frame>.jpg
  ytvis_2021/train/dino_feats/<video>/<frame>.npy
                                               optional DINO patch grids
                                               (Hp, Wp, 384)

Objects move in straight lines and enter or leave the clip; a patch of an
object keeps its DINO feature from frame to frame while the object moves
(the feature is the object's texture at that place on the object), and the
background's patches keep theirs, so adjacent frames have real matches.

    python -m bm2f_tpu_torch.data.synthetic --root DIR [--sizes 480x640 ...]
        [--seed 0] [--ytvis [--frame-size 720x1280] [--video-lengths 5 19 36]]

`--sizes` and `--frame-size` are HxW. `--ytvis` writes `ytvis_2019_val`
(videos of `--video-lengths` frames) and `ytvis_2021_train` (YTVIS_TRAIN_LENGTHS,
with DINO grids) instead of the COCO-format dataset.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from bm2f_tpu_torch.data.mask_ops import rle_encode
from bm2f_tpu_torch.data.panoptic_io import write_panoptic_png

THINGS, STUFF = 5, 3
# COCO val2017 sizes (H x W): the eval's 800 / 1333 resize puts the four
# landscape and portrait ones in its 1344 bucket and the three square ones in
# its 992 bucket (two a bucket at least, so that each has a warm image)
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500), (800, 800), (640, 640),
              (612, 612))


def _categories() -> List[dict]:
    return [{"id": i + 1, "name": f"{'thing' if i < THINGS else 'stuff'}_{i}",
             "isthing": int(i < THINGS)} for i in range(THINGS + STUFF)]


def _image(rng: np.random.RandomState, h: int, w: int):
    """(pixels (h, w, 3) uint8, panoptic ids (h, w), segments)."""
    pan = np.zeros((h, w), np.int64)
    segments = []
    yy, xx = np.mgrid[:h, :w]
    sid = 0
    # stuff: horizontal bands under the void strip
    bands = np.linspace(h // 16, h, STUFF + 1).astype(int)
    for k in range(STUFF):
        sid += 1
        pan[bands[k]:bands[k + 1]] = sid
        segments.append({"id": sid, "category_id": THINGS + k + 1, "iscrowd": 0})
    # things: rectangles and ellipses, the last one a crowd region
    n_things = rng.randint(2, 5)
    for t in range(n_things):
        sid += 1
        y0, x0 = rng.randint(h // 16, h * 3 // 4), rng.randint(0, w * 3 // 4)
        bh, bw = rng.randint(h // 10, h // 3), rng.randint(w // 10, w // 3)
        if t % 2:
            cy, cx = y0 + bh / 2, x0 + bw / 2
            region = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1
        else:
            region = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
        pan[region] = sid
        segments.append({"id": sid, "category_id": int(rng.randint(1, THINGS + 1)),
                         "iscrowd": int(t == n_things - 1)})
    segments = [s for s in segments if (pan == s["id"]).any()]
    colours = rng.randint(0, 256, (sid + 1, 3))
    pixels = colours[pan] + rng.randint(-20, 21, (h, w, 3))
    return np.clip(pixels, 0, 255).astype(np.uint8), pan, segments


def write_synthetic_coco(root: str, sizes: Sequence[Tuple[int, int]] = COCO_SIZES,
                         seed: int = 0) -> Dict[str, str]:
    """Writes the dataset under `root`; returns {dataset name: evaluator
    type} of what `register_all_builtin_datasets(root)` will register."""
    rng = np.random.RandomState(seed)
    coco = os.path.join(root, "coco")
    ade = os.path.join(root, "ADEChallengeData2016")
    dirs = {"img": os.path.join(coco, "val2017"), "ann": os.path.join(coco, "annotations"),
            "pan": os.path.join(coco, "panoptic_val2017"),
            "ade_img": os.path.join(ade, "images", "validation"),
            "ade_sem": os.path.join(ade, "annotations_detectron2", "validation")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cats = _categories()
    images, instances, panoptic = [], [], []
    for image_id, (h, w) in enumerate(sizes, start=1):
        pixels, pan, segments = _image(rng, h, w)
        name = f"{image_id:012d}"
        for d in (dirs["img"], dirs["ade_img"]):
            Image.fromarray(pixels).save(os.path.join(d, name + ".jpg"), quality=95)
        write_panoptic_png(os.path.join(dirs["pan"], name + ".png"), pan)
        sem = np.full((h, w), 255, np.uint8)
        for s in segments:
            sem[pan == s["id"]] = s["category_id"] - 1  # contiguous ids
        Image.fromarray(sem).save(os.path.join(dirs["ade_sem"], name + ".png"))
        images.append({"id": image_id, "file_name": name + ".jpg", "height": h, "width": w})
        panoptic.append({"image_id": image_id, "file_name": name + ".png",
                         "segments_info": segments})
        for s in segments:
            if s["category_id"] > THINGS:
                continue
            m = (pan == s["id"]).astype(np.uint8)
            rle = rle_encode(m)
            if s["iscrowd"]:  # crowd regions as uncompressed RLE, as COCO has them
                flat = m.T.reshape(-1)
                change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
                counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
                rle = {"size": [h, w], "counts": ([0] if flat[0] else []) + counts}
            ys, xs = np.nonzero(m)
            instances.append({
                "id": len(instances) + 1, "image_id": image_id,
                "category_id": s["category_id"], "segmentation": rle,
                "area": int(m.sum()), "iscrowd": s["iscrowd"],
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)]})
    with open(os.path.join(dirs["ann"], "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": instances,
                   "categories": [{k: c[k] for k in ("id", "name")} for c in cats]}, f)
    with open(os.path.join(dirs["ann"], "panoptic_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": panoptic, "categories": cats}, f)
    return {"coco_2017_val": "coco", "coco_2017_val_panoptic": "coco_panoptic_seg",
            "ade20k_sem_seg_val": "sem_seg"}


def write_predicted_instances(root: str, source: str, predictions, num_classes: int
                              ) -> Dict[str, str]:
    """`coco_2017_val` under `root` with the images of the split under
    `source` (copied) and a model's own predictions as its instances, so
    that the mask AP depends on the weights: the model that made them
    scores 100 (less where it predicted empty masks), other weights less.
    `predictions` holds one (labels (N,), masks (N, H, W) bool) pair an
    image, in any order: a pair goes to the image of its masks' size, so
    the split's sizes must differ. Label l is category l + 1 of
    `num_classes`; empty masks are left out. Returns what
    `register_all_builtin_datasets(root)` will register."""
    import shutil

    with open(os.path.join(source, "coco", "annotations", "instances_val2017.json")) as f:
        images = json.load(f)["images"]
    by_size = {(im["height"], im["width"]): im for im in images}
    if len(by_size) != len(images) or len(predictions) != len(images):
        raise ValueError(f"{len(predictions)} predictions for images of sizes "
                         f"{[(im['height'], im['width']) for im in images]}: one an "
                         "image, each of its own size")
    img_dir = os.path.join(root, "coco", "val2017")
    ann_dir = os.path.join(root, "coco", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    instances = []
    for labels, masks in predictions:
        masks = np.asarray(masks, bool)
        im = by_size[masks.shape[1:]]
        shutil.copy(os.path.join(source, "coco", "val2017", im["file_name"]), img_dir)
        for label, m in zip(np.asarray(labels).tolist(), masks):
            if not m.any():
                continue
            ys, xs = np.nonzero(m)
            instances.append({
                "id": len(instances) + 1, "image_id": im["id"],
                "category_id": int(label) + 1, "segmentation": rle_encode(m.astype(np.uint8)),
                "area": int(m.sum()), "iscrowd": 0,
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)]})
    with open(os.path.join(ann_dir, "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": instances,
                   "categories": [{"id": c + 1, "name": f"class_{c}"}
                                  for c in range(num_classes)]}, f)
    return {"coco_2017_val": "coco"}


# YouTube-VIS: 40 classes, 1280x720 frames; the val split's lengths put its
# clips in the eval's 8, 24 and 40 frame buckets
YTVIS_CLASSES, YTVIS_FRAME_HW = 40, (720, 1280)
YTVIS_VAL_LENGTHS, YTVIS_TRAIN_LENGTHS = (5, 19, 36), (6, 7, 8)
# a DINOv2 ViT-S/14 grid of a frame resized to 360x640
DINO_GRID = (26, 46)


def _ytvis_objects(rng: np.random.RandomState, length: int, h: int, w: int) -> List[dict]:
    """Objects moving in straight lines; object 0 is in every frame, the
    others enter or leave, the last is a crowd track."""
    objs = []
    n = rng.randint(3, 5)
    for k in range(n):
        oh, ow = rng.randint(h // 6, h // 3), rng.randint(w // 8, w // 4)
        first = 0 if k == 0 else rng.randint(0, max(length // 2, 1))
        last = length if k == 0 else rng.randint(first + 1, length + 1)
        objs.append({
            "y0": rng.randint(h // 16, h - oh), "x0": rng.randint(0, w - ow), "hw": (oh, ow),
            "v": (rng.uniform(-0.02, 0.02) * h, rng.uniform(-0.02, 0.02) * w),
            "frames": (first, last), "ellipse": bool(k % 2),
            "category_id": int(rng.randint(1, YTVIS_CLASSES + 1)),
            "iscrowd": int(k == n - 1), "colour": rng.randint(0, 256, 3),
        })
    return objs


def _object_box(o: dict, t: int, h: int, w: int) -> Tuple[float, float]:
    """The object's top-left corner at frame t, kept inside the frame."""
    oh, ow = o["hw"]
    y = min(max(o["y0"] + o["v"][0] * t, 0.0), h - oh)
    x = min(max(o["x0"] + o["v"][1] * t, 0.0), w - ow)
    return y, x


def _object_mask(o: dict, y: float, x: float, yy, xx) -> np.ndarray:
    oh, ow = o["hw"]
    if o["ellipse"]:
        return ((yy - y - oh / 2) / (oh / 2)) ** 2 + ((xx - x - ow / 2) / (ow / 2)) ** 2 <= 1
    return (yy >= y) & (yy < y + oh) & (xx >= x) & (xx < x + ow)


def write_synthetic_ytvis(root: str, split: str = "ytvis_2019_val",
                          lengths: Sequence[int] = YTVIS_VAL_LENGTHS,
                          frame_hw: Tuple[int, int] = YTVIS_FRAME_HW, seed: int = 0,
                          feats: bool = False,
                          feat_grid: Tuple[int, int] = DINO_GRID) -> str:
    """Writes the YouTube-VIS split `split` (a name of
    `data.ytvis.YTVIS_SPLITS`) under `root`: one video per entry of
    `lengths`, frames of `frame_hw`, and with `feats` a DINO grid of
    `feat_grid` per frame. Returns the features' root ("" without)."""
    from bm2f_tpu_torch.data.ytvis import DINO_CHANNELS, YTVIS_SPLITS

    json_rel, frames_rel = YTVIS_SPLITS[split]
    frame_root = os.path.join(root, frames_rel)
    feats_root = os.path.join(root, os.path.dirname(frames_rel), "dino_feats") if feats else ""
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    hp, wp = feat_grid
    yy, xx = np.mgrid[:h, :w]
    # patch centres, and a texture of 8x8 cells an object
    py, px = (np.arange(hp) + 0.5) * h / hp, (np.arange(wp) + 0.5) * w / wp
    pyy, pxx = np.meshgrid(py, px, indexing="ij")
    videos, annotations = [], []
    for vid, length in enumerate(lengths, start=1):
        name = f"video{vid:03d}"
        objs = _ytvis_objects(rng, length, h, w)
        bg = rng.randint(0, 256, 3)
        textures = rng.randn(len(objs), 8, 8, DINO_CHANNELS).astype(np.float32)
        bg_feats = rng.randn(hp, wp, DINO_CHANNELS).astype(np.float32)
        tracks = [{"segmentations": [], "bboxes": [], "areas": []} for _ in objs]
        file_names = []
        os.makedirs(os.path.join(frame_root, name), exist_ok=True)
        if feats:
            os.makedirs(os.path.join(feats_root, name), exist_ok=True)
        for t in range(length):
            owner = np.full((h, w), -1, np.int64)
            powner = np.full((hp, wp), -1, np.int64)
            for k, o in enumerate(objs):
                if o["frames"][0] <= t < o["frames"][1]:
                    y, x = _object_box(o, t, h, w)
                    owner[_object_mask(o, y, x, yy, xx)] = k
                    powner[_object_mask(o, y, x, pyy, pxx)] = k
            colours = np.concatenate([np.stack([o["colour"] for o in objs]), bg[None]])
            pixels = colours[owner] + rng.randint(-3, 4, (h, w, 3))
            stem = f"{5 * t:05d}"
            file_names.append(f"{name}/{stem}.jpg")
            Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(
                os.path.join(frame_root, name, stem + ".jpg"), quality=90)
            for k, o in enumerate(objs):
                m = owner == k
                tr = tracks[k]
                if not m.any():
                    tr["segmentations"].append(None)
                    tr["bboxes"].append(None)
                    tr["areas"].append(None)
                    continue
                ys, xs = np.nonzero(m)
                tr["segmentations"].append(rle_encode(m.astype(np.uint8)))
                tr["bboxes"].append([int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                                     int(ys.max() - ys.min() + 1)])
                tr["areas"].append(int(m.sum()))
            if feats:
                grid = bg_feats.copy()
                for k, o in enumerate(objs):
                    sel = powner == k
                    if sel.any():
                        y, x = _object_box(o, t, h, w)
                        cy = np.clip(((pyy[sel] - y) / o["hw"][0] * 8).astype(int), 0, 7)
                        cx = np.clip(((pxx[sel] - x) / o["hw"][1] * 8).astype(int), 0, 7)
                        grid[sel] = textures[k, cy, cx]
                np.save(os.path.join(feats_root, name, stem + ".npy"), grid)
        videos.append({"id": vid, "height": h, "width": w, "length": length,
                       "file_names": file_names})
        for k, o in enumerate(objs):
            if not any(a is not None for a in tracks[k]["areas"]):
                continue
            annotations.append({"id": len(annotations) + 1, "video_id": vid,
                                "category_id": o["category_id"], "iscrowd": o["iscrowd"],
                                "height": h, "width": w, **tracks[k]})
    categories = [{"id": i + 1, "name": f"class_{i}"} for i in range(YTVIS_CLASSES)]
    with open(os.path.join(root, json_rel), "w") as f:
        json.dump({"videos": videos, "annotations": annotations,
                   "categories": categories}, f)
    return feats_root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--sizes", nargs="+", default=None, metavar="HxW")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ytvis", action="store_true",
                    help="write the YouTube-VIS val and train splits instead")
    ap.add_argument("--frame-size", default="x".join(map(str, YTVIS_FRAME_HW)), metavar="HxW")
    ap.add_argument("--video-lengths", nargs="+", type=int, default=list(YTVIS_VAL_LENGTHS))
    args = ap.parse_args(argv)
    if args.ytvis:
        hw = tuple(int(v) for v in args.frame_size.split("x"))
        write_synthetic_ytvis(args.root, "ytvis_2019_val", args.video_lengths, hw, args.seed)
        feats = write_synthetic_ytvis(args.root, "ytvis_2021_train", YTVIS_TRAIN_LENGTHS, hw,
                                      args.seed + 1, feats=True)
        print(f"ytvis_2019_val, ytvis_2021_train (DINO grids under {feats})")
        return 0
    sizes = (COCO_SIZES if args.sizes is None
             else [tuple(int(v) for v in s.split("x")) for s in args.sizes])
    for name, etype in write_synthetic_coco(args.root, sizes, args.seed).items():
        print(f"{name} ({etype})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
