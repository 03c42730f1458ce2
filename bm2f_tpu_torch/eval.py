"""Evaluation entry point of the port: the counterpart of the root `eval.py`
(reference: train_net.py --eval-only -> Trainer.test ->
inference_on_dataset). Dispatches on the dataset's `evaluator_type` like the
reference's build_evaluator (train_net.py:68-148):

  coco               -> instance mask AP       (COCOMaskAPEvaluator)
  sem_seg            -> semantic mIoU          (SemSegEvaluator)
  coco_panoptic_seg  -> panoptic PQ/SQ/RQ      (PanopticEvaluator)
  lvis               -> federated LVIS mask AP (LVISMaskAPEvaluator)

    python -m bm2f_tpu_torch.eval --config coco_instance_r50 \\
        --dataset coco_2017_val [--weights W] [--max-images N] \\
        [--device cuda] [--set KEY=VALUE ...]

Datasets are registered from `$DETECTRON2_DATASETS` (or ./datasets) as the
JAX package registers them (`data/datasets/builtin.py`, `data/cityscapes.py`).
`--weights` takes what `Predictor.setup` takes: a detectron2 .pkl/.pth, a
checkpoint directory of the port or an orbax directory of the JAX package;
none draws seeded random weights (`--seed`).

Images are resized as the reference's test mapper does and padded to one of
a few square buckets (`bucket_ladder`), as the JAX eval pads them for its
compiles; K1 then runs at those buckets. Everything that depends on an
image's original size runs on the device, at that size: the crop of the
padding, the bilinear resize to the original size
(`ops.resize_bilinear_dynamic`, the JAX index math), the binarization and
rescoring of instance masks, the semantic argmax and the panoptic fusion.
Only the results the evaluators read go to the host. The evaluators are
numpy (copies of the JAX package's); their state is merged across the
processes of an initialized `torch.distributed` group before scoring.

Every forward goes through `utils.memory.retry_if_oom`, as the root eval's
do: out of device memory, a batch is halved until it fits (a batch of one
image raises). `--tta` (`models/tta.py`) evaluates `sem_seg` datasets with
multi-scale and flip ensembling, each image at its original size; other
evaluator types ignore it, as the root eval does, and say so once.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _forward(cfg, model, images) -> Dict[str, torch.Tensor]:
    """The network on a (B, H, W, 3) batch of raw pixels (an array, or a
    tensor), on the model's device (f32 models in f32, whatever the global
    flags say)."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.utils.precision import f32_scope

    device = next(model.parameters()).device
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    x = normalize_images(images.to(device), cfg.model)
    with torch.no_grad(), f32_scope(cfg.model.dtype):
        return model(x)


def predictor_fn(cfg, model):
    """(B, H, W, 3) raw pixels -> (pred_logits, pred_masks), through
    `retry_if_oom` (the reference wraps every inference step in
    retry_if_cuda_oom, maskformer_model.py:355-374; the root eval wraps its
    jitted predictions): out of device memory the batch is halved."""
    from bm2f_tpu_torch.utils.memory import retry_if_oom

    def predict(images):
        out = _forward(cfg, model, images)
        return out["pred_logits"], out["pred_masks"]

    return retry_if_oom(predict)


def _to_original(masks: torch.Tensor, pad_hw, valid_hw, orig_hw) -> torch.Tensor:
    """Mask logits (N, h, w) at the prediction stride -> (N, oh, ow): bilinear
    upsample to the padded input, crop the padding, bilinear resize to the
    original size (reference maskformer_model.py:337-371, sem_seg_postprocess)."""
    from bm2f_tpu_torch.ops import resize_bilinear, resize_bilinear_dynamic

    full = resize_bilinear(masks, *pad_hw)
    return resize_bilinear_dynamic(full, valid_hw, orig_hw, *orig_hw)


def instance_on_device(logits: torch.Tensor, masks: torch.Tensor, pad_hw, valid_hw,
                       orig_hw, *, num_classes: int, topk: int) -> Dict[str, torch.Tensor]:
    """One image's instances at its original size (reference :573-623):
    top-k over the flattened Q x K scores, the selected masks at the
    original size, binarized at 0, scores times the mean mask probability
    over each mask (reference :621). Each mask is restored on its own, so
    out of device memory `retry_if_oom` halves the selected masks (at the
    1344 bucket, 100 of them take ~2 GB on the way)."""
    from bm2f_tpu_torch.models.maskformer import instance_topk_select
    from bm2f_tpu_torch.utils.memory import retry_if_oom

    def restore(sel):
        m = _to_original(sel, pad_hw, valid_hw, orig_hw)
        binary = m > 0
        prob = torch.sigmoid(m)
        area = binary.flatten(1).sum(-1)
        return binary, (prob * binary).flatten(1).sum(-1) / (area + 1e-6)

    scores, labels, sel = instance_topk_select(logits, masks, num_classes=num_classes,
                                               topk=topk)
    binary, mask_scores = retry_if_oom(restore)(sel)
    return {"scores": scores * mask_scores, "labels": labels, "masks": binary}


def _build_loader(cfg, dataset_name, short_edge, max_size, bucket,
                  rank=0, world_size=1, carry_dict=False, batch_size=1):
    from bm2f_tpu_torch.data import build_test_loader
    from bm2f_tpu_torch.data.mappers import EvalMapper

    base = EvalMapper(short_edge=short_edge, max_size=max_size,
                      bucket=bucket, pad_value=cfg.model.pixel_mean)
    if carry_dict:
        # keep the raw dataset dict with each sample (collate passes
        # non-array values through as ragged lists) so GT lookup does not
        # depend on image_id being present
        def mapper(dd):
            s = base(dd)
            s["_dd"] = dd
            return s
    else:
        mapper = base
    return build_test_loader(dataset_name, mapper, batch_size=batch_size,
                             rank=rank, world_size=world_size)


def _record(timings: Optional[List[dict]], batch, t0: float) -> None:
    """With `timings`, appends the batch's {"bucket", "ms"}: the host clock
    from the batch's arrival (`t0`) to the end of its evaluation, the copies
    to the host (which wait for the device) and the evaluator's work
    included."""
    if timings is not None:
        timings.append({"bucket": int(batch["images"].shape[1]),
                        "ms": (time.perf_counter() - t0) * 1e3})


def eval_instance(cfg, model, dataset_name: str, max_images: int = 0,
                  short_edge: int = 800, max_size: int = 1333,
                  bucket=(704, 960, 1344), rank: int = 0, world_size: int = 1,
                  protocol: str = "coco", timings: Optional[List[dict]] = None,
                  ims_per_batch: int = 1):
    """Instance mask AP (reference inference: maskformer_model.py:573-623).
    protocol="lvis" applies the federated LVIS protocol (300 dets/image,
    neg/not-exhaustive category handling; reference train_net.py:126-128)."""
    from bm2f_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
    from bm2f_tpu_torch.evaluation.coco_eval import COCOMaskAPEvaluator
    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator

    num_classes = cfg.model.num_classes
    topk = 300 if protocol == "lvis" else 100
    loader = _build_loader(cfg, dataset_name, short_edge, max_size, bucket,
                           rank, world_size, batch_size=ims_per_batch)
    predict = predictor_fn(cfg, model)
    dicts = {d["image_id"]: d for d in DatasetCatalog.get(dataset_name)}
    if protocol == "lvis":
        from bm2f_tpu_torch.evaluation.lvis_eval import LVISMaskAPEvaluator

        freqs = getattr(MetadataCatalog.get(dataset_name),
                        "class_frequencies", None)
        evaluator = LVISMaskAPEvaluator(num_classes, frequencies=freqs)
    else:
        evaluator = COCOMaskAPEvaluator(num_classes)

    n = 0
    for batch in loader:
        t0 = time.perf_counter()
        logits, masks = predict(batch["images"])
        pad_hw = batch["images"].shape[1:3]
        for i in range(len(batch["images"])):
            oh, ow = batch["orig_hw"][i]
            with torch.no_grad():
                inst = instance_on_device(
                    logits[i], masks[i], pad_hw,
                    batch["resized_hw"][i], (oh, ow), num_classes=num_classes, topk=topk)
            inst = {k: v.cpu().numpy() for k, v in inst.items()}
            inst["valid"] = np.ones(len(inst["masks"]), bool)
            dd = dicts[int(batch["image_id"][i])]
            # crowd annotations are kept and flagged: the COCO protocol treats
            # them as ignore regions (predictions matching them are neither TP
            # nor FP), which COCOMaskAPEvaluator implements natively.
            gt_masks = [
                segmentation_to_mask(a["segmentation"], oh, ow)
                for a in dd["annotations"]
            ]
            gt = {
                "labels": np.asarray(
                    [a["category_id"] for a in dd["annotations"]], np.int64,
                ),
                "masks": np.stack(gt_masks) if gt_masks else np.zeros((0, oh, ow)),
                "iscrowd": np.asarray(
                    [bool(a.get("iscrowd", 0)) for a in dd["annotations"]], bool,
                ),
            }
            if protocol == "lvis":
                gt["neg_categories"] = dd.get("neg_category_ids", ())
                gt["not_exhaustive_categories"] = dd.get(
                    "not_exhaustive_category_ids", ())
            evaluator.process(inst, gt)
            n += 1
        _record(timings, batch, t0)
        del logits, masks  # not held through the next batch's forward
        if max_images and n >= max_images:
            break
    res = gather_evaluator(evaluator).evaluate()
    print({k: round(v, 2) for k, v in res.items()})
    return res


def load_sem_gt(dd) -> np.ndarray:
    if dd.get("sem_seg") is not None:
        return np.asarray(dd["sem_seg"])
    from PIL import Image

    with Image.open(dd["sem_seg_file_name"]) as im:
        return np.asarray(im)


def semantic_on_device(logits: torch.Tensor, masks: torch.Tensor, pad_hw, valid_hw,
                       orig_hw) -> torch.Tensor:
    """One image's semantic labels (oh, ow) (reference: semantic_inference
    maskformer_model.py:509-513): class probabilities at the prediction
    stride, the valid region resized to the original size, argmax over
    classes (the JAX eval does the resize and argmax on the host)."""
    from bm2f_tpu_torch.models.maskformer import semantic_inference
    from bm2f_tpu_torch.ops import resize_bilinear_dynamic

    sem = semantic_inference(logits, masks)  # (h4, w4, K)
    stride = pad_hw[0] / sem.shape[0]
    h4 = max(int(round(valid_hw[0] / stride)), 1)
    w4 = max(int(round(valid_hw[1] / stride)), 1)
    probs = resize_bilinear_dynamic(sem.permute(2, 0, 1), (h4, w4), orig_hw, *orig_hw)
    return probs.argmax(0)


def eval_semantic(cfg, model, dataset_name: str, max_images: int = 0,
                  short_edge: int = 512, max_size: int = 2048,
                  bucket=(512, 768, 1024), rank: int = 0, world_size: int = 1,
                  timings: Optional[List[dict]] = None, ims_per_batch: int = 1,
                  tta: bool = False):
    """Semantic mIoU (reference: semantic_inference maskformer_model.py:509-513
    + d2 SemSegEvaluator, train_net.py:78-86). With `tta`, multi-scale and
    flip ensembling (`models/tta.py`, test_time_augmentation.py:21) of each
    image at its original size (no resize, no bucket), the images shared
    out by `rank::world_size` as the root eval does, the prediction the
    argmax of the averaged probabilities (the first class among equals);
    `timings` then receives one {"hw", "ms"} per image."""
    from bm2f_tpu_torch.data import MetadataCatalog
    from bm2f_tpu_torch.evaluation import SemSegEvaluator
    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator

    meta = MetadataCatalog.get(dataset_name)
    evaluator = SemSegEvaluator(cfg.model.num_classes,
                                ignore_label=getattr(meta, "ignore_label", 255))
    predict = predictor_fn(cfg, model)
    if tta:
        return _eval_semantic_tta(cfg, model, predict, evaluator, dataset_name,
                                  max_images, rank, world_size, timings)
    loader = _build_loader(cfg, dataset_name, short_edge, max_size, bucket,
                           rank, world_size, carry_dict=True, batch_size=ims_per_batch)
    n = 0
    for batch in loader:
        t0 = time.perf_counter()
        logits, masks = predict(batch["images"])
        pad_hw = batch["images"].shape[1:3]
        for i in range(len(batch["images"])):
            with torch.no_grad():
                pred = semantic_on_device(logits[i], masks[i],
                                          pad_hw, batch["resized_hw"][i],
                                          batch["orig_hw"][i])
            evaluator.process(pred.cpu().numpy(), load_sem_gt(batch["_dd"][i]))
            n += 1
        _record(timings, batch, t0)
        del logits, masks  # not held through the next batch's forward
        if max_images and n >= max_images:
            break
    res = gather_evaluator(evaluator).evaluate()
    print({k: round(v, 2) for k, v in res.items()})
    return res


def _eval_semantic_tta(cfg, model, predict, evaluator, dataset_name, max_images,
                       rank, world_size, timings):
    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.mappers import read_image
    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator
    from bm2f_tpu_torch.models.tta import semantic_tta
    from bm2f_tpu_torch.utils.precision import f32_scope

    device = next(model.parameters()).device
    n = 0
    for dd in DatasetCatalog.get(dataset_name)[rank::world_size]:
        t0 = time.perf_counter()
        img = dd.get("image")
        if img is None:
            img = read_image(dd["file_name"])
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
        with torch.no_grad(), f32_scope(cfg.model.dtype):
            pred = semantic_tta(predict, x).argmax(-1)
        evaluator.process(pred.cpu().numpy(), load_sem_gt(dd))
        if timings is not None:
            timings.append({"hw": list(img.shape[:2]),
                            "ms": (time.perf_counter() - t0) * 1e3})
        n += 1
        if max_images and n >= max_images:
            break
    res = gather_evaluator(evaluator).evaluate()
    print({k: round(v, 2) for k, v in res.items()})
    return res


def panoptic_on_device(cfg, logits: torch.Tensor, masks: torch.Tensor, pad_hw,
                       valid_hw, orig_hw, thing_mask) -> Dict[str, torch.Tensor]:
    """One image's panoptic fusion at its original size, in the reference's
    order (maskformer_model.py:337-371): the mask logits upsampled to the
    padded input, cropped, resized to the original size, and only then
    fused (`panoptic_inference`)."""
    from bm2f_tpu_torch.models.maskformer import panoptic_inference

    return panoptic_inference(
        logits, _to_original(masks, pad_hw, valid_hw, orig_hw),
        num_classes=cfg.model.num_classes, thing_mask=thing_mask,
        object_mask_threshold=cfg.model.test.object_mask_threshold,
        overlap_threshold=cfg.model.test.overlap_threshold,
    )


def eval_panoptic(cfg, model, dataset_name: str, max_images: int = 0,
                  short_edge: int = 800, max_size: int = 1333,
                  bucket=(704, 960, 1344), rank: int = 0, world_size: int = 1,
                  timings: Optional[List[dict]] = None, ims_per_batch: int = 1):
    """Panoptic PQ/SQ/RQ (reference: panoptic_inference
    maskformer_model.py:515-571 + d2 COCOPanopticEvaluator)."""
    from bm2f_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from bm2f_tpu_torch.data.panoptic_io import read_panoptic_png
    from bm2f_tpu_torch.evaluation import PanopticEvaluator
    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator
    from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic

    # materialize the dataset FIRST: panoptic registrations populate the
    # thing/stuff id maps lazily inside their loader (data/coco.py), so
    # reading metadata before DatasetCatalog.get would give an all-stuff
    # thing_mask
    DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    num_classes = cfg.model.num_classes
    thing_ids = set(getattr(meta, "thing_dataset_id_to_contiguous_id", {}).values())
    thing_mask = tuple(c in thing_ids for c in range(num_classes))
    if not thing_ids:
        print(f"WARNING: {dataset_name} registered no thing classes — "
              "panoptic fusion will merge every class as stuff")
    evaluator = PanopticEvaluator(num_classes, thing_mask)
    loader = _build_loader(cfg, dataset_name, short_edge, max_size, bucket,
                           rank, world_size, carry_dict=True, batch_size=ims_per_batch)
    predict = predictor_fn(cfg, model)
    n = 0
    for batch in loader:
        t0 = time.perf_counter()
        logits, masks = predict(batch["images"])
        pad_hw = batch["images"].shape[1:3]
        for i in range(len(batch["images"])):
            with torch.no_grad():
                pan = panoptic_on_device(cfg, logits[i], masks[i],
                                         pad_hw, batch["resized_hw"][i],
                                         batch["orig_hw"][i], thing_mask)
            seg_map, segments = relabel_panoptic({k: v.cpu().numpy() for k, v in pan.items()})
            # evaluator wants -1 = void; relabel used 0 = void, ids from 1
            pred_map = seg_map.astype(np.int64) - 1
            pred_segments = [
                {"id": s["id"] - 1, "category_id": s["category_id"]}
                for s in segments
            ]
            dd = batch["_dd"][i]
            gt_png = dd.get("pan_seg")
            if gt_png is None:
                gt_png = read_panoptic_png(dd["pan_seg_file_name"])
            gt_map = gt_png.astype(np.int64) - 1  # png id 0 = void -> -1
            gt_segments = [
                {"id": s["id"] - 1, "category_id": s["category_id"],
                 "iscrowd": s.get("iscrowd", 0)}
                for s in dd["segments_info"]
            ]
            evaluator.process(pred_map, pred_segments, gt_map, gt_segments)
            n += 1
        _record(timings, batch, t0)
        del logits, masks  # not held through the next batch's forward
        if max_images and n >= max_images:
            break
    res = gather_evaluator(evaluator).evaluate()
    print({k: round(v, 2) for k, v in res.items()})
    return res


def bucket_ladder(max_size: int, steps=(0.5, 0.72, 1.0)):
    """Padding-bucket ladder for eval: the largest bucket is
    ceil(max_size/32)*32, so the max_size-capped resize ALWAYS fits (no
    silent shrink-to-fit); smaller buckets bound padding waste for typical
    aspect ratios."""
    top = -(-max_size // 32) * 32
    return tuple(sorted({-(-int(top * f) // 32) * 32 for f in steps}))


def run_eval(cfg, model, dataset_name: str, max_images: int = 0,
             short_edge: int = None, max_size: int = None, bucket=None,
             tta: bool = False, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             timings: Optional[List[dict]] = None, ims_per_batch: int = 1):
    """Evaluator dispatch on the dataset's evaluator_type (reference:
    train_net.py:68-148 build_evaluator). Test resolution comes from
    cfg.input.min_size_test / max_size_test unless given. Rank and world
    size come from `torch.distributed` when it is initialized (one process
    otherwise) unless given. `timings`, when given, receives one
    {"bucket", "ms"} per batch (`_record`). `tta` applies to `sem_seg`
    datasets only (as the root `run_eval` passes it only to
    `eval_semantic`); elsewhere it is ignored, with a warning.
    `ims_per_batch` images go through each forward (the root eval's 1 by
    default); above 1 every image pads to the largest bucket, so that a
    batch stacks."""
    import torch.distributed as dist

    from bm2f_tpu_torch.data import MetadataCatalog

    if short_edge is None:
        short_edge = cfg.input.min_size_test
    if max_size is None:
        max_size = cfg.input.max_size_test
    if bucket is None:
        bucket = bucket_ladder(max_size)
    if ims_per_batch > 1:
        bucket = (max(bucket),)
    if rank is None or world_size is None:
        on = dist.is_available() and dist.is_initialized()
        rank, world_size = (dist.get_rank(), dist.get_world_size()) if on else (0, 1)

    args = (cfg, model, dataset_name, max_images, short_edge, max_size, bucket,
            rank, world_size)
    kw = dict(timings=timings, ims_per_batch=ims_per_batch)
    etype = getattr(MetadataCatalog.get(dataset_name), "evaluator_type", "coco")
    if tta and etype != "sem_seg":
        print(f"WARNING: --tta applies to sem_seg datasets only; {dataset_name} "
              f"({etype}) is evaluated without it")
    if etype == "sem_seg":
        return eval_semantic(*args, tta=tta, **kw)
    if etype == "coco_panoptic_seg":
        return eval_panoptic(*args, **kw)
    if etype == "lvis":
        return eval_instance(*args, protocol="lvis", **kw)
    return eval_instance(*args, **kw)


def main(argv=None):
    from bm2f_tpu_torch.config import parse_override

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--weights", default="",
                    help="d2 .pkl/.pth, a port checkpoint dir or an orbax dir")
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--tta", action="store_true",
                    help="multi-scale + flip ensembling (sem_seg datasets only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)

    from bm2f_tpu_torch.data.cityscapes import register_all_cityscapes
    from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
    from bm2f_tpu_torch.predict import Predictor

    register_all_builtin_datasets()
    register_all_cityscapes()
    pred = Predictor()
    pred.setup(args.config, args.weights, device=args.device, seed=args.seed,
               overrides=dict(args.set))
    return run_eval(pred.cfg, pred.model, args.dataset, args.max_images, tta=args.tta)


if __name__ == "__main__":
    main()
