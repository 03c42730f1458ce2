"""COCO mask codec + rasterization, implemented natively (pycocotools is not
available in this environment and the framework avoids the dependency).

Formats handled (COCO spec):
- polygon lists [[x0, y0, x1, y1, ...], ...]  -> rasterized via PIL;
- uncompressed RLE {"counts": [int, ...], "size": [h, w]};
- compressed RLE {"counts": "<LEB128-ish string>", "size": [h, w]} using the
  COCO byte encoding (column-major order).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE -> (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_compressed_counts(
            counts.encode("ascii") if isinstance(counts, str) else counts
        )
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> compressed COCO RLE."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)  # column-major
    # run lengths, starting with a run of zeros (possibly length 0)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": _encode_compressed_counts(runs).decode("ascii")}


def _decode_compressed_counts(s: bytes) -> List[int]:
    """COCO's modified LEB128 with sign extension and delta coding."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_compressed_counts(counts: Sequence[int]) -> bytes:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def polygons_to_mask(polygons: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon list to (H, W) uint8 (union of polygons)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def segmentation_to_mask(seg: Union[List, Dict], h: int, w: int) -> np.ndarray:
    """Any COCO segmentation format -> (H, W) uint8."""
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        return rle_decode(seg)
    raise TypeError(f"unsupported segmentation type {type(seg)}")


def mask_to_box(mask: np.ndarray) -> np.ndarray:
    """(H, W) -> xyxy float box (0-area box if empty)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.asarray(
        [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32
    )


def mask_area(rle_or_mask) -> float:
    if isinstance(rle_or_mask, dict):
        return float(rle_decode(rle_or_mask).sum())
    return float(np.asarray(rle_or_mask).sum())


def rle_iou(a: Dict, b: Dict, iscrowd: bool = False) -> float:
    """IoU between two RLEs (decoded; small masks only — eval-time helper)."""
    ma, mb = rle_decode(a).astype(bool), rle_decode(b).astype(bool)
    inter = float(np.logical_and(ma, mb).sum())
    if iscrowd:
        denom = float(ma.sum())
    else:
        denom = float(np.logical_or(ma, mb).sum())
    return inter / denom if denom > 0 else 0.0
