"""Video instance segmentation evaluation of the port: the counterpart of the
root `eval_video.py` (reference: train_net_video.py --eval-only ->
YTVISEvaluator): track AP on a YouTube-VIS split.

    python -m bm2f_tpu_torch.eval_video --config ytvis2019_video_r50 \\
        --dataset ytvis_2019_val [--weights W] [--max-videos N] \\
        [--device cuda] [--set KEY=VALUE ...]

The splits are registered from `$DETECTRON2_DATASETS` (or ./datasets) as the
JAX package registers them (`data/ytvis.py`). `--weights` takes what the image
eval takes (`utils.convert_weights.load_weights`: a detectron2 .pkl/.pth, a
checkpoint directory of the port or an orbax directory of the JAX package);
none draws seeded random weights (`--seed`).

Each video is evaluated whole, in one forward, as the reference does
(video_maskformer_model.py:623-694). Its frames are resized as the test
mapper resizes them and padded into a square spatial bucket; its length is
padded to a frame bucket, with a `frame_valid` mask that keeps the padded
frames out of every cross-attention, so that the predictions are those of
the clip at its true length. The buckets are the JAX eval's: frames (4, 8,
16, 24, 40), then x1.5 rounded up to 8 above the ladder; spatial r32(short *
16 / 9), r32(2 * short) and r32(max_size). The top-k tracks over Q x K are
taken on the device (the lower index first among equal scores, as
`jax.lax.top_k`), and so is the restoration to the original size (the
image eval's `_to_original`; the JAX eval does it on the host with the same
index math). Only the tracks' binary masks go to the host, where the numpy
evaluator (`evaluation/ytvis_eval.py`) scores them. Each clip's forward
goes through `utils.memory.retry_if_oom`, as the root eval's does; a clip is
one item, so out of device memory it frees the allocator's cache and raises,
naming the clip's shape.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

T_BUCKETS = (4, 8, 16, 24, 40)


def frame_bucket(T: int, t_buckets: Sequence[int] = T_BUCKETS) -> int:
    """The smallest frame bucket that holds T frames; above the ladder it
    grows x1.5, rounded up to a multiple of 8 (one compile in the JAX
    package per ~1.5x band of lengths, never a truncation)."""
    t_buckets = tuple(sorted(t_buckets))
    Tp = next((t for t in t_buckets if t >= T), None)
    if Tp is None:
        Tp = t_buckets[-1]
        while Tp < T:
            Tp = -(-(Tp * 3) // 16) * 8  # ceil(Tp * 1.5 / 8) * 8
    return Tp


def spatial_buckets(short_edge: int, max_size: int):
    """A 16:9 landscape bucket, a tall middle step and a top bucket that
    always holds the max_size-capped resize, each rounded up to 32."""
    def r32(s):
        return -(-s // 32) * 32

    return tuple(sorted({r32(short_edge * 16 // 9), r32(short_edge * 2), r32(max_size)}))


def prepare_clip(dd, T: int, short_edge: int, max_size: int, s_buckets: Sequence[int],
                 t_buckets: Sequence[int] = T_BUCKETS):
    """The first T frames of the video `dd` as the test mapper resizes them
    (short edge `short_edge`, long edge at most `max_size`), padded into the
    smallest spatial bucket that holds them and to the frame bucket of T:
    (clip (1, Tp, S, S, 3) raw pixels, frame_valid (1, Tp), (nh, nw))."""
    from bm2f_tpu_torch.data.mappers import read_image
    from bm2f_tpu_torch.data.transforms import resize_image

    Tp = frame_bucket(T, t_buckets)
    h, w = dd["height"], dd["width"]
    scale = short_edge / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    S = next((b for b in s_buckets if b >= max(nh, nw)), s_buckets[-1])
    clip = np.zeros((1, Tp, S, S, 3), np.float32)
    for t in range(T):
        clip[0, t, :nh, :nw] = resize_image(read_image(dd["file_names"][t]), nh, nw)
    fv = np.zeros((1, Tp), bool)
    fv[0, :T] = True
    return clip, fv, (nh, nw)


def predict_clip(cfg, model, clip: np.ndarray, frame_valid: np.ndarray, topk: int):
    """The network on one padded clip (1, Tp, S, S, 3) of raw pixels and its
    (1, Tp) frame mask, on the model's device (an f32 model in f32,
    whatever the global flags say): the top-k (scores, labels, mask logits
    (k, Tp, h4, w4)) over the flattened Q x K scores."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.utils.precision import f32_scope
    from bm2f_tpu_torch.video.video_maskformer import topk_stable

    device = next(model.parameters()).device
    x = normalize_images(torch.from_numpy(clip).to(device), cfg.model)
    fv = torch.from_numpy(frame_valid).to(device)
    K = cfg.model.num_classes
    with torch.no_grad(), f32_scope(cfg.model.dtype):
        out = model(x, fv)
        flat = torch.softmax(out["pred_logits"][0], dim=-1)[:, :-1].reshape(-1)
        scores, idx = topk_stable(flat, min(topk, flat.shape[0]))
        return scores, idx % K, out["pred_masks"][0][idx // K]


def run_video_eval(cfg, model, dataset_name: str, max_videos: int = 0,
                   short_edge: Optional[int] = None, bucket=None,
                   max_size: Optional[int] = None, max_frames: int = 0,
                   t_buckets: Sequence[int] = T_BUCKETS, rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timings: Optional[List[dict]] = None):
    """Track AP of `model` (a `VideoMaskFormer`) on the registered split
    `dataset_name`. The test resolution comes from cfg.input.min_size_test /
    max_size_test unless given; `bucket` overrides the spatial ladder (an
    int or a sequence). `max_frames` > 0 truncates longer videos, and says
    so. Rank and world size come from `torch.distributed` when it is
    initialized (one process otherwise) unless given; each rank takes a
    contiguous share of the videos and the evaluator state is gathered
    before scoring. `timings`, when given, receives one {"frames" (the
    bucket), "size" (the spatial bucket), "T" (the video's length), "ms",
    "load_ms", "predict_ms"} per video: the host clock from reading its
    first frame to the end of its evaluation, of which the reading and
    resizing of its frames, and the network, the top-k and the restored
    masks' copy to the host (which waits for the device)."""
    import torch.distributed as dist

    from bm2f_tpu_torch.data import DatasetCatalog
    from bm2f_tpu_torch.data.mask_ops import segmentation_to_mask
    from bm2f_tpu_torch.eval import _to_original
    from bm2f_tpu_torch.evaluation.evaluator import gather_evaluator
    from bm2f_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator
    from bm2f_tpu_torch.utils.memory import retry_if_oom

    if short_edge is None:
        short_edge = cfg.input.min_size_test
    if max_size is None:
        max_size = cfg.input.max_size_test
    if bucket is None:
        bucket = spatial_buckets(short_edge, max_size)
    s_buckets = tuple(sorted((bucket,) if isinstance(bucket, int) else tuple(bucket)))
    if rank is None or world_size is None:
        on = dist.is_available() and dist.is_initialized()
        rank, world_size = (dist.get_rank(), dist.get_world_size()) if on else (0, 1)

    topk = cfg.model.test.topk_per_video
    predict = retry_if_oom(lambda clip, fv: predict_clip(cfg, model, clip, fv, topk))
    evaluator = YTVISEvaluator(cfg.model.num_classes)
    dicts = DatasetCatalog.get(dataset_name)
    shard = (len(dicts) + world_size - 1) // world_size
    n = 0
    for dd in dicts[rank * shard:(rank + 1) * shard]:
        t0 = time.perf_counter()
        T = dd["length"]
        if max_frames and T > max_frames:
            print(f"WARNING: truncating video {dd.get('video_id')} from "
                  f"{T} to {max_frames} frames (max_frames set)")
            T = max_frames
        h, w = dd["height"], dd["width"]
        clip, fv, (nh, nw) = prepare_clip(dd, T, short_edge, max_size, s_buckets, t_buckets)
        Tp, S = clip.shape[1:3]
        t1 = time.perf_counter()

        scores, labels, sel = predict(clip, fv)
        k = sel.shape[0]
        with torch.no_grad():
            full = _to_original(sel[:, :T].flatten(0, 1), (S, S), (nh, nw), (h, w))
            pred_masks = (full > 0).reshape(k, T, h, w).cpu().numpy()
        t2 = time.perf_counter()

        gts, gt_labels, gt_crowd = [], [], []
        for ann in dd["annotations"]:
            per = np.zeros((T, h, w), bool)
            any_p = False
            for t in range(T):
                seg = ann["segmentations"][t]
                if seg is not None:
                    per[t] = segmentation_to_mask(seg, h, w) > 0
                    any_p = True
            if any_p:
                gts.append(per)
                gt_labels.append(ann["category_id"])
                gt_crowd.append(ann.get("iscrowd", 0))
        evaluator.process(
            {"video_id": dd["video_id"], "scores": scores.cpu().numpy(),
             "labels": labels.cpu().numpy(), "masks": pred_masks},
            {"labels": np.asarray(gt_labels, np.int64),
             "masks": np.stack(gts) if gts else np.zeros((0, T, h, w), bool),
             "iscrowd": np.asarray(gt_crowd, bool)},
        )
        if timings is not None:
            timings.append({"frames": Tp, "size": S, "T": T,
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "load_ms": (t1 - t0) * 1e3, "predict_ms": (t2 - t1) * 1e3})
        n += 1
        if max_videos and n >= max_videos:
            break
    res = gather_evaluator(evaluator).evaluate()
    print({k: round(v, 2) for k, v in res.items()})
    return res


def main(argv=None):
    from bm2f_tpu_torch.config import get_config, parse_override
    from bm2f_tpu_torch.data.ytvis import register_all_ytvis
    from bm2f_tpu_torch.video import build_video_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ytvis2019_video_r50")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--weights", default="",
                    help="d2 .pkl/.pth, a port checkpoint dir or an orbax dir")
    ap.add_argument("--max-videos", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)

    register_all_ytvis()
    cfg = get_config(args.config, dict(args.set))
    model = build_video_model(cfg, device=args.device, seed=args.seed)
    if args.weights:
        from bm2f_tpu_torch.utils.convert_weights import load_weights

        model.load_state_dict(load_weights(args.weights, cfg), strict=True)
    model.cast_weights_for_inference_()
    return run_video_eval(cfg, model, args.dataset, args.max_videos)


if __name__ == "__main__":
    main()
