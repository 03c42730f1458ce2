"""Builtin dataset registrations (reference: mask2former/data/datasets/*.py
~2.8k LoC of registrars + category constants).

TPU-framework redesign: category metadata (names, isthing flags, id maps)
is read from the dataset's own json at load time instead of being vendored
as python constants, so registration here is just path wiring. Dataset root
comes from $DETECTRON2_DATASETS (same convention as the reference) or
./datasets.

Registered (when present on disk):
- coco_2017_{train,val}            instance segmentation
- coco_2017_{train,val}_panoptic   panoptic (+ semseg derived)
- coco_2017_debug                  mini split (reference register_coco_debug.py)
- ade20k_sem_seg_{train,val}       semantic
- ade20k_instance_{train,val}, ade20k_panoptic_{train,val}
- cityscapes_fine_sem_seg_{train,val}
- mapillary_vistas_sem_seg_{train,val}
"""

from __future__ import annotations

import os
from typing import Optional

from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from bm2f_tpu_torch.data.coco import (
    load_coco_json,
    register_coco_instances,
    register_coco_panoptic,
)

_REGISTERED = False


def _root() -> str:
    return os.environ.get("DETECTRON2_DATASETS", "datasets")


def register_sem_seg_folder(name: str, image_dir: str, gt_dir: str,
                            num_classes: int, ignore_label: int = 255,
                            image_ext: str = ".jpg", gt_ext: str = ".png"):
    """Folder-paired semantic segmentation dataset (reference:
    register_ade20k_full.py style: load_sem_seg)."""

    def load():
        import glob

        gts = sorted(glob.glob(os.path.join(gt_dir, "*" + gt_ext)))
        out = []
        for g in gts:
            stem = os.path.splitext(os.path.basename(g))[0]
            img = os.path.join(image_dir, stem + image_ext)
            out.append({"file_name": img, "sem_seg_file_name": g})
        return out

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(
        image_root=image_dir,
        sem_seg_root=gt_dir,
        evaluator_type="sem_seg",
        ignore_label=ignore_label,
        num_classes=num_classes,
    )


def register_coco_panoptic_with_sem_seg(name: str, json_file: str,
                                        image_root: str, panoptic_root: str,
                                        sem_seg_root: str):
    """Panoptic dicts augmented with derived semantic pngs so one dataset
    serves panoptic, instance, and semantic training/eval (reference:
    register_coco_panoptic_annos_semseg.py:75-160)."""
    from bm2f_tpu_torch.data.coco import load_coco_panoptic_json

    def load():
        dicts = load_coco_panoptic_json(
            json_file, image_root, panoptic_root, name)
        for d in dicts:
            png = os.path.basename(d["pan_seg_file_name"])
            d["sem_seg_file_name"] = os.path.join(sem_seg_root, png)
        return dicts

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(
        evaluator_type="coco_panoptic_seg",
        sem_seg_root=sem_seg_root,
        panoptic_root=panoptic_root,
        image_root=image_root,
        ignore_label=255,
    )


def register_all_builtin_datasets(root: Optional[str] = None,
                                  force: bool = False) -> None:
    """Idempotent; silently skips splits whose files are absent. `force`
    re-registers (tests pointing at synthetic roots)."""
    global _REGISTERED
    if _REGISTERED and not force:
        return
    _REGISTERED = True
    if force:
        DatasetCatalog.allow_overwrite = True
    root = root or _root()

    def j(*p):
        return os.path.join(root, *p)

    # ---- COCO instance ----
    for split in ("train", "val"):
        json_file = j("coco", "annotations", f"instances_{split}2017.json")
        image_root = j("coco", f"{split}2017")
        if os.path.exists(json_file):
            register_coco_instances(f"coco_2017_{split}", json_file, image_root)

    # mini debug split (reference: register_coco_debug.py:8-24 points a small
    # json at val2017)
    dbg = j("coco", "annotations", "instances_debug2017.json")
    if os.path.exists(dbg):
        register_coco_instances("coco_2017_debug", dbg, j("coco", "val2017"))

    # ---- LVIS v1 (evaluator dispatch: reference train_net.py:126-128) ----
    from bm2f_tpu_torch.data.datasets.lvis import register_lvis_instances

    for split in ("train", "val"):
        lj = j("lvis", f"lvis_v1_{split}.json")
        if os.path.exists(lj):
            # LVIS images live in the COCO dirs; file_name carries the split
            register_lvis_instances(f"lvis_v1_{split}", lj, j("coco"))

    # ---- COCO panoptic ----
    for split in ("train", "val"):
        pj = j("coco", "annotations", f"panoptic_{split}2017.json")
        if os.path.exists(pj):
            register_coco_panoptic(
                f"coco_2017_{split}_panoptic",
                pj,
                j("coco", f"{split}2017"),
                j("coco", f"panoptic_{split}2017"),
            )
            # panoptic annotations + derived per-pixel semantic pngs
            # (reference: register_coco_panoptic_annos_semseg.py:129-160;
            # pngs produced by tools/prepare_coco_semantic_annos_from_
            # panoptic_annos.py)
            semseg_dir = j("coco", f"panoptic_semseg_{split}2017")
            if os.path.isdir(semseg_dir):
                register_coco_panoptic_with_sem_seg(
                    f"coco_2017_{split}_panoptic_with_sem_seg",
                    pj,
                    j("coco", f"{split}2017"),
                    j("coco", f"panoptic_{split}2017"),
                    semseg_dir,
                )

    # ---- ADE20K ----
    ade = j("ADEChallengeData2016")
    if os.path.isdir(ade):
        for split, sdir in (("train", "training"), ("val", "validation")):
            register_sem_seg_folder(
                f"ade20k_sem_seg_{split}",
                os.path.join(ade, "images", sdir),
                os.path.join(ade, "annotations_detectron2", sdir),
                num_classes=150,
            )
        for split in ("train", "val"):
            ij = os.path.join(ade, f"ade20k_instance_{split}.json")
            if os.path.exists(ij):
                register_coco_instances(
                    f"ade20k_instance_{split}", ij, os.path.join(
                        ade, "images", "training" if split == "train" else "validation"
                    )
                )
            pj = os.path.join(
                ade, "ade20k_panoptic_" + split + ".json"
            )
            if os.path.exists(pj):
                register_coco_panoptic(
                    f"ade20k_panoptic_{split}", pj,
                    os.path.join(ade, "images",
                                 "training" if split == "train" else "validation"),
                    os.path.join(ade, f"ade20k_panoptic_{split}"),
                )

    # ---- Cityscapes (semantic; detectron2 folder layout) ----
    cs = j("cityscapes")
    if os.path.isdir(cs):
        for split in ("train", "val"):
            register_sem_seg_folder(
                f"cityscapes_fine_sem_seg_{split}",
                os.path.join(cs, "leftImg8bit", split),
                os.path.join(cs, "gtFine", split),
                num_classes=19,
                image_ext="_leftImg8bit.png",
                gt_ext="_labelTrainIds.png",
            )

    # ---- ADE20K-full (847 classes; reference register_ade20k_full.py:944) ----
    ade_full = j("ADE20K_2021_17_01")
    if os.path.isdir(ade_full):
        for split, sdir in (("train", "training"), ("val", "validation")):
            register_sem_seg_folder(
                f"ade20k_full_sem_seg_{split}",
                os.path.join(ade_full, "images_detectron2", sdir),
                os.path.join(ade_full, "annotations_detectron2", sdir),
                num_classes=847,
                ignore_label=65535,  # uint16 gts; 65535 = unlabeled
                gt_ext=".tif",
            )

    # ---- COCO-Stuff-10k (171 classes; register_coco_stuff_10k.py:200) ----
    stuff = j("coco", "coco_stuff_10k")
    if os.path.isdir(stuff):
        for split, idir, gdir in (
            ("train", "images_detectron2/train", "annotations_detectron2/train"),
            ("test", "images_detectron2/test", "annotations_detectron2/test"),
        ):
            register_sem_seg_folder(
                f"coco_2017_{split}_stuff_10k_sem_seg",
                os.path.join(stuff, idir),
                os.path.join(stuff, gdir),
                num_classes=171,
            )

    # ---- Mapillary Vistas semantic ----
    mv = j("mapillary_vistas")
    if os.path.isdir(mv):
        for split in ("training", "validation"):
            short = "train" if split == "training" else "val"
            register_sem_seg_folder(
                f"mapillary_vistas_sem_seg_{short}",
                os.path.join(mv, split, "images"),
                os.path.join(mv, split, "labels_detectron2"),
                num_classes=65,
            )
            # panoptic (reference register_mapillary_vistas_panoptic.py:489:
            # panoptic_2018 json + pngs under <split>/panoptic)
            pj = os.path.join(mv, split, "panoptic", "panoptic_2018.json")
            if os.path.exists(pj):
                register_coco_panoptic(
                    f"mapillary_vistas_panoptic_{short}",
                    pj,
                    os.path.join(mv, split, "images"),
                    os.path.join(mv, split, "panoptic"),
                )

    DatasetCatalog.allow_overwrite = False
