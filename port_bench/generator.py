"""The one generator of every traffic mix. A mix is a JSON file under
`traffic/`, whose parameters this module reads; its `driver` names the
loop that sends it (`drivers.py`):

- "requests": single images in a closed loop. `shapes` (H, W) and
  `per_cycle` counts: every cycle of sum(per_cycle) requests holds each
  shape that many times, in an order drawn from the seed, so that every
  seed sends the same work. `images_per_shape` distinct images of each
  shape are made in set-up and reused.
- "train": batches of `batch` images on a `canvas` (H, W), a pool of
  `pool_batches` batches made in set-up on the device and cycled. The
  pool's instance counts are the quantiles, at the midpoints of as many
  equal shares as it has images, of `instances` {"min", "mean", "shape",
  "max"}: min + a negative binomial of mean (mean - min) and that shape
  (1: a geometric tail), clipped to max. Batch j holds the (j x batch)-th
  smallest counts on, so that every seed steps the same batches (the
  work, and the memory a batch's instances take, are the seed's alike);
  the seed orders the batches and the images within each. Each
  instance's area class is drawn from `area_split`, the share of small,
  medium and large instances; `area_px` gives their ranges of areas in
  canvas pixels. With `content_short_edges`, each image's content is
  resized to one of those short edges (long edge at most
  `content_max_long`) and padded to the canvas.

Images are smooth: a low-frequency colour field (a `field_grid` x
`field_grid` grid of colours, resized bilinearly) with every instance
painted on it as a filled ellipse of its own colour, at least
`min_contrast` from the field under it. Instances are ellipses of log-
uniform aspect in [1/2, 2] and any angle.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

AREA_CLASSES = ("small", "medium", "large")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of `--seed`."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2 ** 63 - 1)


def _gen(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def colour_field(h: int, w: int, grid: int, gen: torch.Generator, device) -> torch.Tensor:
    """(h, w, 3) smooth colours in [0, 255]."""
    coarse = torch.rand((1, 3, grid, grid), generator=gen, device=device) * 255
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[0].permute(
        1, 2, 0)


def _area_classes(n: int, split: Mapping[str, float]) -> List[str]:
    """n classes in the split's proportions (largest remainder)."""
    raw = [split[c] * n for c in AREA_CLASSES]
    counts = [int(math.floor(r)) for r in raw]
    for i in sorted(range(3), key=lambda i: raw[i] - counts[i], reverse=True)[:n - sum(counts)]:
        counts[i] += 1
    return [c for c, k in zip(AREA_CLASSES, counts) for _ in range(k)]


def ellipses(n: int, h: int, w: int, classes: List[str], area_px: Mapping[str, List[float]],
             gen: torch.Generator, device) -> torch.Tensor:
    """(n, h, w) bool filled ellipses, the i-th of area class classes[i]."""
    lo = torch.tensor([math.log(area_px[c][0]) for c in classes], device=device)
    hi = torch.tensor([math.log(area_px[c][1]) for c in classes], device=device)
    u = torch.rand((n, 5), generator=gen, device=device)
    area = torch.exp(lo + (hi - lo) * u[:, 0])
    aspect = torch.exp((u[:, 1] * 2 - 1) * math.log(2.0))
    a = torch.sqrt(area * aspect / math.pi)  # semi-axes: pi a b = area
    b = area / (math.pi * a)
    cy, cx = u[:, 2] * h, u[:, 3] * w
    th = u[:, 4] * math.pi
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :] + 0.5
    dy, dx = ys - cy[:, None, None], xs - cx[:, None, None]
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    r = ((dx * c + dy * s) / a[:, None, None]) ** 2 + ((dy * c - dx * s) / b[:, None, None]) ** 2
    return r <= 1.0


def paint(field: torch.Tensor, masks: torch.Tensor, contrast: float,
          gen: torch.Generator) -> torch.Tensor:
    """Paints each mask in a colour at least `contrast` (per channel, in
    one channel or more) from the field's mean colour under it."""
    img = field.clone()
    for m in masks:
        under = field[m].mean(0) if bool(m.any()) else field.mean((0, 1))
        col = torch.rand(3, generator=gen, device=field.device) * 255
        far = (col - under).abs().amax() >= contrast
        if not bool(far):
            col = torch.where(under < 128, under + contrast, under - contrast)
        img[m] = col
    return img


def instance_counts(spec: Mapping, n: int) -> List[int]:
    """n images' instance counts, ascending: the midpoint quantiles of
    min + NegBin(mean - min, shape), clipped to max."""
    from scipy.stats import nbinom

    lo, m, r = int(spec["min"]), float(spec["mean"]) - int(spec["min"]), float(spec["shape"])
    q = nbinom.ppf((np.arange(n) + 0.5) / n, r, r / (r + m))
    return [int(min(lo + k, int(spec["max"]))) for k in q]


def train_pool(mix: Mapping, seed: int, device, max_instances: int, num_classes: int,
               limit: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """The pool of batches of a "train" mix: images (B, H, W, 3) f32 in
    [0, 255], labels (B, G) int32 (-1 on padding), masks (B, G, H, W) f32,
    valid (B, G) bool, G = `max_instances`, as the port's mappers pad.
    `limit` makes only the first batches (the same as the whole pool's)."""
    B, (H, W) = int(mix["batch"]), mix["canvas"]
    if int(mix["instances"]["max"]) > max_instances:
        raise ValueError(f"up to {mix['instances']['max']} instances an image; targets pad "
                         f"to {max_instances}")
    rng = np.random.default_rng(sub_seed(seed, "pool"))
    n_batches = int(mix["pool_batches"])
    sizes = instance_counts(mix["instances"], n_batches * B)
    counts = [sizes[j * B + i] for j in rng.permutation(n_batches) for i in rng.permutation(B)]
    split = [float(mix["area_split"][c]) for c in AREA_CLASSES]
    gen = _gen(seed, "pool", device)
    n_make = len(counts) if limit is None else min(len(counts), limit * B)
    images, labels, masks, valid = [], [], [], []
    for n in counts[:n_make]:
        h, w = content_size(mix, rng)
        classes = [AREA_CLASSES[i] for i in rng.choice(3, size=n, p=np.divide(split, sum(split)))]
        m = torch.zeros((max_instances, H, W), dtype=torch.bool, device=device)
        m[:n, :h, :w] = ellipses(n, h, w, classes, mix["area_px"], gen, device)
        img = torch.zeros((H, W, 3), device=device)
        field = colour_field(h, w, int(mix["field_grid"]), gen, device)
        img[:h, :w] = paint(field, m[:n, :h, :w], float(mix["min_contrast"]), gen)
        lab = torch.full((max_instances,), -1, dtype=torch.int32, device=device)
        lab[:n] = torch.randint(0, num_classes, (n,), generator=gen, device=device,
                                dtype=torch.int32)
        v = torch.zeros(max_instances, dtype=torch.bool, device=device)
        v[:n] = True
        images.append(img)
        labels.append(lab)
        masks.append(m.float())
        valid.append(v)
    return [{"images": torch.stack(images[j:j + B]), "labels": torch.stack(labels[j:j + B]),
             "masks": torch.stack(masks[j:j + B]), "valid": torch.stack(valid[j:j + B])}
            for j in range(0, len(images), B)]


def content_size(mix: Mapping, rng: np.random.Generator) -> Tuple[int, int]:
    """The (h, w) an image's content takes on the canvas: the whole canvas,
    or a short edge from `content_short_edges` and a COCO aspect."""
    H, W = mix["canvas"]
    if "content_short_edges" not in mix:
        return H, W
    short = int(rng.choice(mix["content_short_edges"]))
    aspect = float(rng.choice(mix["content_aspects"]))  # width / height
    h, w = (short, round(short * aspect)) if aspect >= 1 else (round(short / aspect), short)
    scale = min(1.0, mix["content_max_long"] / max(h, w))
    return min(H, round(h * scale)), min(W, round(w * scale))


def draw_points(gen: torch.Generator, layers: int, batch: int, num_points: int,
                oversample: float, importance: float) -> Dict[str, torch.Tensor]:
    """The mask criterion's random points of one step: "match" (L, B, N, 2),
    "cand" (L, B, oversample N, 2), "rand" (L, B, N - importance N, 2)."""
    dev = gen.device
    n_rand = num_points - int(importance * num_points)
    return {name: torch.rand((layers, batch, n, 2), generator=gen, device=dev)
            for name, n in (("match", num_points), ("cand", int(num_points * oversample)),
                            ("rand", n_rand))}


def request_order(mix: Mapping, seed: int, cycles: int) -> List[int]:
    """Shape indices of `cycles` cycles of requests, each cycle the mix's
    counts in an order drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "order"))
    cycle = [i for i, k in enumerate(mix["per_cycle"]) for _ in range(int(k))]
    return [int(s) for _ in range(cycles) for s in rng.permutation(cycle)]


def request_images(mix: Mapping, seed: int, device) -> List[List[np.ndarray]]:
    """`images_per_shape` uint8 (H, W, 3) host images of each shape, each
    with `instances` painted ellipses of the mix's area split."""
    gen = _gen(seed, "images", device)
    rng = np.random.default_rng(sub_seed(seed, "images"))
    out = []
    for h, w in mix["shapes"]:
        per = []
        for _ in range(int(mix["images_per_shape"])):
            n = int(mix["instances"])
            classes = _area_classes(n, mix["area_split"])
            classes = [classes[j] for j in rng.permutation(n)]
            m = ellipses(n, h, w, classes, mix["area_px"], gen, device)
            field = colour_field(h, w, int(mix["field_grid"]), gen, device)
            img = paint(field, m, float(mix["min_contrast"]), gen)
            per.append(img.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        out.append(per)
    return out
