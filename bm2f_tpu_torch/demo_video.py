"""Video instance segmentation demo of the port (the counterpart of the root
`demo_video.py`; reference: demo_video/{demo,predictor,visualizer}.py):
tracks over a clip of frames, one overlaid PNG per frame.

    python -m bm2f_tpu_torch.demo_video --config ytvis2019_video_r50 \\
        --input frames_dir/ --output out/ [--weights W] [--confidence 0.5] \\
        [--max-frames N] [--device cuda] [--set KEY=VALUE ...]

The whole clip runs in one forward at its native resolution, padded to
`size_divisibility`, with `model.num_frames` set to its length: no frame
bucket and no test resize, unlike `eval_video.py`. The tracks are the
stable top-k of `video_maskformer.track_topk`, whose scores come from the
class logits alone, so only the selected queries' masks are resized to the
padded size, cropped and thresholded: the same tracks as resizing all Q
queries' masks first (root demo_video.py:72-75; 13 GB in f32 for 100
queries x 36 frames at 720x1280). The overlay and its text are the root's
(`demo.color_palette`).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def clip_tracks(cfg, model, clip: torch.Tensor, hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """The tracks of one padded clip (1, T, ph, pw, 3) of raw pixels on the
    model's device: scores (k,), labels (k,), masks (k, T, H, W) bool, each
    selected query's mask logits resized to (ph, pw) and cropped to `hw`."""
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops import resize_bilinear
    from bm2f_tpu_torch.utils.precision import f32_scope
    from bm2f_tpu_torch.video.video_maskformer import track_topk

    H, W = hw
    ph, pw = clip.shape[2:4]
    with torch.no_grad(), f32_scope(cfg.model.dtype):
        out = model(normalize_images(clip, cfg.model))
        scores, labels, queries = track_topk(
            out["pred_logits"][0], num_classes=cfg.model.num_classes,
            topk=cfg.model.test.topk_per_video)
        masks = resize_bilinear(out["pred_masks"][0][queries], ph, pw)[..., :H, :W]
    return {"scores": scores, "labels": labels, "masks": masks > 0.0}


def draw_tracks(imgs: Sequence[np.ndarray], tracks: Dict[str, np.ndarray],
                confidence: float):
    """Each frame with the tracks scoring at least `confidence` overlaid and
    labelled (root demo_video.py:84-100). Yields PIL images."""
    from PIL import Image, ImageDraw

    from bm2f_tpu_torch.demo import color_palette

    palette = color_palette(len(tracks["scores"]))
    keep = tracks["scores"] >= confidence
    for t in range(len(imgs)):
        vis = imgs[t].astype(np.float32)
        for k in np.where(keep)[0]:
            m = tracks["masks"][k, t]
            vis[m] = 0.5 * vis[m] + 0.5 * palette[k]
        pil = Image.fromarray(vis.astype(np.uint8))
        d_ = ImageDraw.Draw(pil)
        for k in np.where(keep)[0]:
            ys, xs = np.nonzero(tracks["masks"][k, t])
            if len(ys):
                d_.text((int(xs.min()), int(ys.min())),
                        f"track{k} c{int(tracks['labels'][k])} {tracks['scores'][k]:.2f}",
                        fill=(255, 255, 255))
        yield pil


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns {"frames", "written", "padded_hw", "tracks_kept", "seconds":
    the host clock from the first frame's read to the last PNG}."""
    from bm2f_tpu_torch.config import parse_override

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ytvis2019_video_r50")
    ap.add_argument("--input", required=True, help="directory of frame images")
    ap.add_argument("--output", default="demo_video_out")
    ap.add_argument("--weights", default="")
    ap.add_argument("--confidence", type=float, default=0.5)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE", help="a config field, e.g. model.dtype=bfloat16")
    args = ap.parse_args(argv)

    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.data.mappers import read_image
    from bm2f_tpu_torch.video import build_video_model

    t0 = time.perf_counter()
    frames = sorted(glob.glob(os.path.join(args.input, "*.jpg"))
                    + glob.glob(os.path.join(args.input, "*.png")))
    if args.max_frames:
        frames = frames[: args.max_frames]
    if not frames:
        raise FileNotFoundError(f"no frames in {args.input}")
    imgs = [read_image(f) for f in frames]
    H, W = imgs[0].shape[:2]
    T = len(imgs)

    cfg = get_config(args.config, {**dict(args.set), "model.num_frames": T})
    model = build_video_model(cfg, device=args.device)
    if args.weights:
        from bm2f_tpu_torch.utils.convert_weights import load_weights

        model.load_state_dict(load_weights(args.weights, cfg), strict=True)
    model.cast_weights_for_inference_()
    d = cfg.model.size_divisibility
    ph, pw = (H + d - 1) // d * d, (W + d - 1) // d * d
    clip = torch.zeros((1, T, ph, pw, 3), dtype=torch.float32)
    for t, im in enumerate(imgs):
        clip[0, t, :H, :W] = torch.tensor(im)

    tracks = clip_tracks(cfg, model, clip.to(args.device), (H, W))
    tracks = {k: v.cpu().numpy() for k, v in tracks.items()}
    os.makedirs(args.output, exist_ok=True)
    written = []
    for t, pil in enumerate(draw_tracks(imgs, tracks, args.confidence)):
        written.append(os.path.join(args.output, f"{t:05d}.png"))
        pil.save(written[-1])
    print(f"wrote {T} frames to {args.output}")
    return {"frames": T, "written": written, "padded_hw": (ph, pw),
            "tracks_kept": int((tracks["scores"] >= args.confidence).sum()),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
