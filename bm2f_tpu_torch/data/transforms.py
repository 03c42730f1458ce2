"""Host-side (numpy/PIL) augmentations matching the reference's detectron2
transform usage:

- `ResizeShortestEdge` + `RandomFlip` (+ optional `ColorAugSSD`, crop) for
  the semantic/panoptic/instance mappers (reference:
  mask_former_semantic_dataset_mapper.py:61-84);
- LSJ: `RandomFlip` + `ResizeScale(0.1..2.0)` + `FixedSizeCrop(sq)` for the
  COCO new-baseline mappers (reference:
  coco_instance_new_baseline_dataset_mapper.py:37-66).

All transforms return (image, fns) where fns apply the same geometric
transform to masks / semantic maps, keeping image/GT alignment exact.
Static output shapes (the fixed crop / pad-to-divisibility) are what make
the downstream pipeline jit-able.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image


def _to_pil(img: np.ndarray) -> Image.Image:
    return Image.fromarray(img.astype(np.uint8))


def resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.asarray(_to_pil(img).resize((w, h), Image.BILINEAR))


def resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.asarray(_to_pil(mask).resize((w, h), Image.NEAREST))


@dataclasses.dataclass
class GeomTransform:
    """Composable geometric transform record: resize -> crop -> flip."""

    resize_hw: Tuple[int, int]
    crop_yx: Tuple[int, int] = (0, 0)
    crop_hw: Optional[Tuple[int, int]] = None
    flip: bool = False
    pad_hw: Optional[Tuple[int, int]] = None

    def apply_image(self, img: np.ndarray, pad_value: float = 128.0) -> np.ndarray:
        img = resize_image(img, *self.resize_hw)
        return self._crop_flip_pad(img, pad_value)

    def apply_mask(self, mask: np.ndarray) -> np.ndarray:
        mask = resize_mask(mask, *self.resize_hw)
        return self._crop_flip_pad(mask, 0)

    def apply_segmap(self, seg: np.ndarray, ignore_value: int = 255) -> np.ndarray:
        seg = resize_mask(seg, *self.resize_hw)
        return self._crop_flip_pad(seg, ignore_value)

    def _crop_flip_pad(self, x: np.ndarray, pad_value) -> np.ndarray:
        """crop -> flip -> pad. Padding is applied AFTER the flip so it always
        lands bottom/right in the final orientation, matching the reference
        (LSJ: RandomFlip precedes FixedSizeCrop; semantic mappers: flip
        precedes the pad-to-divisibility)."""
        if self.crop_hw is not None:
            y0, x0 = self.crop_yx
            ch, cw = self.crop_hw
            x = x[y0 : y0 + ch, x0 : x0 + cw]
        if self.flip:
            x = x[:, ::-1]
        targets = []
        if self.crop_hw is not None:
            targets.append(self.crop_hw)
        if self.pad_hw is not None:
            targets.append(self.pad_hw)
        for ph, pw in targets:
            if x.shape[0] < ph or x.shape[1] < pw:
                pads = [(0, max(0, ph - x.shape[0])), (0, max(0, pw - x.shape[1]))]
                if x.ndim == 3:
                    pads.append((0, 0))
                x = np.pad(x, pads, constant_values=pad_value)
        return x


def lsj_transform(
    rng: np.random.RandomState,
    img_h: int,
    img_w: int,
    image_size: int,
    min_scale: float = 0.1,
    max_scale: float = 2.0,
    flip_prob: float = 0.5,
) -> GeomTransform:
    """Large-scale jittering (reference LSJ mapper): random scale of the
    target size, then fixed-size crop/pad to (image_size, image_size)."""
    scale = rng.uniform(min_scale, max_scale)
    # d2 ResizeScale: scale target size, keep aspect by min ratio
    th, tw = image_size * scale, image_size * scale
    ratio = min(th / img_h, tw / img_w)
    nh, nw = int(img_h * ratio + 0.5), int(img_w * ratio + 0.5)
    # FixedSizeCrop: random crop if bigger, pad (bottom/right) if smaller
    max_y = max(0, nh - image_size)
    max_x = max(0, nw - image_size)
    y0 = int(rng.uniform(0, max_y + 1)) if max_y > 0 else 0
    x0 = int(rng.uniform(0, max_x + 1)) if max_x > 0 else 0
    return GeomTransform(
        resize_hw=(nh, nw),
        crop_yx=(y0, x0),
        crop_hw=(min(nh, image_size), min(nw, image_size)),
        flip=bool(rng.rand() < flip_prob),
        pad_hw=(image_size, image_size),
    )


def shortest_edge_transform(
    rng: np.random.RandomState,
    img_h: int,
    img_w: int,
    short_edge_choices: Tuple[int, ...],
    max_size: int = 2048,
    flip_prob: float = 0.5,
    crop_size: Optional[Tuple[int, int]] = None,
    pad_divisibility: int = 32,
    fixed_pad: Optional[Tuple[int, int]] = None,
) -> GeomTransform:
    """ResizeShortestEdge (+optional absolute crop) + flip + pad."""
    se = int(short_edge_choices[rng.randint(len(short_edge_choices))])
    scale = se / min(img_h, img_w)
    if max(img_h, img_w) * scale > max_size:
        scale = max_size / max(img_h, img_w)
    nh, nw = int(img_h * scale + 0.5), int(img_w * scale + 0.5)
    crop_yx, crop_hw = (0, 0), None
    out_h, out_w = nh, nw
    if crop_size is not None:
        ch, cw = min(crop_size[0], nh), min(crop_size[1], nw)
        y0 = rng.randint(0, nh - ch + 1)
        x0 = rng.randint(0, nw - cw + 1)
        crop_yx, crop_hw = (y0, x0), (ch, cw)
        out_h, out_w = ch, cw
    if fixed_pad is not None:
        pad_hw = fixed_pad
    else:
        d = pad_divisibility
        pad_hw = ((out_h + d - 1) // d * d, (out_w + d - 1) // d * d)
    return GeomTransform(
        resize_hw=(nh, nw),
        crop_yx=crop_yx,
        crop_hw=crop_hw,
        flip=bool(rng.rand() < flip_prob),
        pad_hw=pad_hw,
    )


def color_aug_ssd(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """SSD-style photometric distortion (reference: ColorAugSSDTransform —
    brightness/contrast/saturation/hue jitter), numpy/PIL implementation."""
    img = img.astype(np.float32)
    if rng.rand() < 0.5:  # brightness
        img += rng.uniform(-32, 32)
    if rng.rand() < 0.5:  # contrast
        img *= rng.uniform(0.5, 1.5)
    # saturation/hue via HSV
    from PIL import Image as _I

    img = np.clip(img, 0, 255).astype(np.uint8)
    hsv = np.asarray(_I.fromarray(img).convert("HSV"), dtype=np.float32)
    if rng.rand() < 0.5:  # saturation
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(0.5, 1.5), 0, 255)
    if rng.rand() < 0.5:  # hue
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-18, 18)) % 256
    out = _I.fromarray(hsv.astype(np.uint8), mode="HSV").convert("RGB")
    return np.asarray(out)


def _bilinear_index_weights(in_size: int, out_size: int):
    """Source indices and lambda weights for 1-D half-pixel bilinear
    (torch `upsample_bilinear2d` with align_corners=False), in numpy: the
    JAX package's `ops/interpolate.py` helper, copied."""
    i = np.arange(out_size, dtype=np.float64)
    scale = in_size / out_size
    src = np.maximum((i + 0.5) * scale - 0.5, 0.0)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.minimum(i0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    w0 = 1.0 - w1
    return i0, i1, w0, w1


def resize_bilinear_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize with torch align_corners=False semantics
    (the index math of the JAX package's `resize_bilinear`). x: (..., H, W).
    The port's eval resizes masks on the device instead; this is the host
    reference of that path."""
    h, w = x.shape[-2], x.shape[-1]
    if h != out_h:
        i0, i1, w0, w1 = _bilinear_index_weights(h, out_h)
        x = x[..., i0, :] * w0[:, None] + x[..., i1, :] * w1[:, None]
    if w != out_w:
        i0, i1, w0, w1 = _bilinear_index_weights(w, out_w)
        x = x[..., i0] * w0 + x[..., i1] * w1
    return x
