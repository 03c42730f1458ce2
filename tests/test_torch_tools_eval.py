"""The port's evaluation tools against the JAX package's, loaded from their
paths under tools/: `evaluate_coco_boundary_ap` (`mask_to_boundary_region`
and `boundary_iou` bitwise on seeded masks of odd sizes; the CLI's printed
dict on a small synthetic instances JSON and predictions JSON) and
`evaluate_pq_for_semantic_segmentation` (`class_map_to_segments` bitwise;
the CLI's printed dict on seeded class PNGs, class ids at and above
--num-classes included). Host numpy on both sides: every result is equal,
not close."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from bm2f_tpu_torch.data.mask_ops import rle_encode
from bm2f_tpu_torch.tools import evaluate_coco_boundary_ap as port_bap
from bm2f_tpu_torch.tools import evaluate_pq_for_semantic_segmentation as port_spq

ROOT = Path(__file__).resolve().parent.parent


def jax_tool(name: str):
    """tools/<name>.py, loaded from its path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch, capsys) -> str:
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()
    return capsys.readouterr().out


def _blob_masks(rng, n, h, w):
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, h / 2), rng.uniform(2, w / 2)
        out.append(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)
    return out


@pytest.fixture(scope="module")
def bap():
    return jax_tool("evaluate_coco_boundary_ap")


@pytest.mark.parametrize("hw", [(37, 51), (5, 9), (64, 33), (101, 1)])
@pytest.mark.parametrize("ratio", [0.02, 0.05, 0.3])
def test_boundary_region_and_iou_bitwise(bap, rng, hw, ratio):
    a, b = _blob_masks(rng, 2, *hw)
    noise = rng.rand(*hw) < 0.1
    for m in (a, b, a ^ noise, np.ones(hw, bool), np.zeros(hw, np.uint8)):
        np.testing.assert_array_equal(port_bap.mask_to_boundary_region(m, ratio),
                                      bap.mask_to_boundary_region(m, ratio))
    assert port_bap.boundary_iou(a, b, ratio) == bap.boundary_iou(a, b, ratio)
    assert port_bap.boundary_iou(a, a ^ noise, ratio) == bap.boundary_iou(a, a ^ noise, ratio)


def _instances(rng, tmp_path):
    """A COCO instances JSON of 3 images (RLE and polygon ground truth, a
    crowd, an image without annotations) and predictions near and far
    from the ground truth."""
    sizes = [(45, 61), (64, 64), (33, 77)]
    gt = {"images": [], "annotations": [],
          "categories": [{"id": 3, "name": "a"}, {"id": 7, "name": "b"}, {"id": 9, "name": "c"}]}
    preds = []
    for i, (h, w) in enumerate(sizes):
        gt["images"].append({"id": i + 1, "height": h, "width": w, "file_name": f"{i}.jpg"})
        if i == 2:
            continue
        for j, m in enumerate(_blob_masks(rng, 4, h, w)):
            cat = (3, 7, 9)[j % 3]
            gt["annotations"].append({
                "id": len(gt["annotations"]) + 1, "image_id": i + 1, "category_id": cat,
                "segmentation": rle_encode(m.astype(np.uint8)), "iscrowd": int(j == 3)})
            near = np.roll(m, rng.randint(0, 2), axis=rng.randint(2))
            preds.append({"image_id": i + 1, "category_id": cat, "score": float(rng.rand()),
                          "segmentation": rle_encode(near.astype(np.uint8))})
        gt["annotations"].append({
            "id": len(gt["annotations"]) + 1, "image_id": i + 1, "category_id": 7,
            "segmentation": [[2.0, 2.0, 20.0, 3.0, 18.0, 25.0, 4.0, 22.0]], "iscrowd": 0})
    for m in _blob_masks(rng, 3, *sizes[2]):  # predictions on the empty image
        preds.append({"image_id": 3, "category_id": 9, "score": float(rng.rand()),
                      "segmentation": rle_encode(m.astype(np.uint8))})
    gt_path, pred_path = tmp_path / "gt.json", tmp_path / "pred.json"
    gt_path.write_text(json.dumps(gt))
    pred_path.write_text(json.dumps(preds))
    return gt_path, pred_path


@pytest.mark.parametrize("ratio", ["0.02", "0.1"])
def test_boundary_ap_cli_prints_the_jax_dict(bap, rng, tmp_path, monkeypatch, capsys, ratio):
    gt_path, pred_path = _instances(rng, tmp_path)
    argv = ["--gt-json", str(gt_path), "--pred-json", str(pred_path),
            "--dilation-ratio", ratio]
    ref = run_jax_main(bap, argv, monkeypatch, capsys)
    res = port_bap.main(argv)
    ours = capsys.readouterr().out
    assert ours == ref
    assert 0 < res["BoundaryAP"] < 100, res


@pytest.fixture(scope="module")
def spq():
    return jax_tool("evaluate_pq_for_semantic_segmentation")


@pytest.mark.parametrize("num_classes", [1, 6, 20])
def test_class_map_to_segments_bitwise(spq, rng, num_classes):
    seg = rng.randint(0, 8, (23, 17))
    seg[:3] = 255
    ours, ours_info = port_spq.class_map_to_segments(seg, num_classes)
    ref, ref_info = spq.class_map_to_segments(seg, num_classes)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype and ours_info == ref_info


@pytest.mark.parametrize("num_stuff", [0, 3])
def test_semantic_pq_cli_prints_the_jax_dict(spq, rng, tmp_path, monkeypatch, capsys,
                                             num_stuff):
    K = 6
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(4):
        gt = rng.randint(0, K + 2, (30 + i, 41)).astype(np.uint8)  # K, K+1: void
        gt[:, :5] = 255
        pred = gt.copy()
        flip = rng.rand(*gt.shape) < 0.2 * i
        pred[flip] = rng.randint(0, K + 1, int(flip.sum()))
        Image.fromarray(gt).save(gt_dir / f"{i:03d}.png")
        Image.fromarray(pred).save(pred_dir / f"{i:03d}.png")
    argv = ["--pred-dir", str(pred_dir), "--gt-dir", str(gt_dir), "--num-classes", str(K),
            "--num-stuff", str(num_stuff)]
    ref = run_jax_main(spq, argv, monkeypatch, capsys)
    res = port_spq.main(argv)
    assert capsys.readouterr().out == ref
    assert 0 < res["PQ"] < 100, res
