"""Panoptic png id encoding (panopticapi convention: id = R + 256*G + 256^2*B)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def read_panoptic_png(path: str) -> np.ndarray:
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint32)
    return rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]


def write_panoptic_png(path: str, ids: np.ndarray):
    ids = ids.astype(np.uint32)
    rgb = np.stack(
        [ids % 256, (ids // 256) % 256, (ids // (256 * 256)) % 256], axis=-1
    ).astype(np.uint8)
    Image.fromarray(rgb).save(path)
