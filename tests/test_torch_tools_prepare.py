"""The port's four dataset preparation tools against the JAX package's,
loaded from their paths under tools/, on small ADE20K and COCO-panoptic
trees written here from a numpy seed. Each side runs on its own copy of the
tree; the JSONs must be equal and every PNG equal array for array.

`prepare_coco_semantic_annos_from_panoptic_annos` maps its images through a
`multiprocessing.Pool`; here both tools take a pool that maps in the
calling process (the test process holds JAX's threads, which a fork would
copy), so that each converts the same images with the same function."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from bm2f_tpu_torch.data.panoptic_io import write_panoptic_png
from bm2f_tpu_torch.tools import (
    prepare_ade20k_ins_seg,
    prepare_ade20k_pan_seg,
    prepare_ade20k_sem_seg,
    prepare_coco_semantic_annos_from_panoptic_annos,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = {"prepare_ade20k_sem_seg": prepare_ade20k_sem_seg,
        "prepare_ade20k_ins_seg": prepare_ade20k_ins_seg,
        "prepare_ade20k_pan_seg": prepare_ade20k_pan_seg,
        "prepare_coco_semantic_annos_from_panoptic_annos":
            prepare_coco_semantic_annos_from_panoptic_annos}


def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SerialPool:
    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return list(map(fn, items))


def run_both(name, jax_root, port_root, monkeypatch, extra=()):
    mod = jax_tool(name)
    for m in (mod, PORT[name]):
        if hasattr(m, "mp"):
            monkeypatch.setattr(m.mp, "Pool", SerialPool)
    monkeypatch.setattr(sys, "argv", [mod.__file__, "--dataset-root", str(jax_root), *extra])
    mod.main()
    PORT[name].main(["--dataset-root", str(port_root), *extra])


def assert_trees_equal(a: Path, b: Path):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b
    for rel in files_a:
        if rel.suffix == ".json":
            assert json.loads((a / rel).read_text()) == json.loads((b / rel).read_text()), rel
        elif rel.suffix == ".png":
            with Image.open(a / rel) as x, Image.open(b / rel) as y:
                assert x.mode == y.mode, rel
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(rel))


def _write_ade20k(root: Path, rng):
    """ADEChallengeData2016 with class maps (0 = unlabeled, 1..150) and
    instance PNGs (R = thing class 1..100, 0 = none; G = instance id) for
    3 training and 2 validation images of odd sizes; one validation image
    has no instance PNG."""
    for split, n in (("training", 3), ("validation", 2)):
        for d in ("annotations", "annotations_instance"):
            (root / d / split).mkdir(parents=True)
        for i in range(n):
            h, w = 31 + 6 * i, 47 - 4 * i
            stem = f"ADE_{split}_{i:08d}"
            sem = rng.randint(0, 151, (h // 4 + 1, w // 4 + 1))
            sem = np.kron(sem, np.ones((4, 4), int))[:h, :w].astype(np.uint8)
            Image.fromarray(sem).save(root / "annotations" / split / f"{stem}.png")
            if split == "validation" and i == 1:
                continue
            cls = np.zeros((h, w), np.uint8)
            ins = np.zeros((h, w), np.uint8)
            for k in range(5):
                y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
                cls[y:y + 6, x:x + 8] = rng.randint(1, 101)
                ins[y:y + 6, x:x + 8] = k % 3 + 1
            inst = np.stack([cls, ins, np.zeros_like(cls)], -1)
            Image.fromarray(inst).save(root / "annotations_instance" / split / f"{stem}.png")


@pytest.fixture
def ade_trees(tmp_path, rng):
    jax_root = tmp_path / "jax" / "ADEChallengeData2016"
    _write_ade20k(jax_root, rng)
    port_root = tmp_path / "port" / "ADEChallengeData2016"
    shutil.copytree(jax_root, port_root)
    return jax_root, port_root


def test_ade20k_sem_ins_pan_equal_jax(ade_trees, monkeypatch):
    """The three ADE20K steps in their order (the panoptic step reads the
    semantic step's output); after each, the two trees are equal."""
    jax_root, port_root = ade_trees
    for name in ("prepare_ade20k_sem_seg", "prepare_ade20k_ins_seg", "prepare_ade20k_pan_seg"):
        run_both(name, jax_root, port_root, monkeypatch)
        assert_trees_equal(jax_root, port_root)
    ins = json.loads((port_root / "ade20k_instance_train.json").read_text())
    pan = json.loads((port_root / "ade20k_panoptic_val.json").read_text())
    assert ins["annotations"] and len(pan["annotations"]) == 2
    assert {c["isthing"] for c in pan["categories"]} == {0, 1}


def test_ade20k_ins_and_pan_skip_missing_inputs(tmp_path, monkeypatch, capsys):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for name in ("prepare_ade20k_ins_seg", "prepare_ade20k_pan_seg"):
        run_both(name, jax_root, port_root, monkeypatch)
        out = capsys.readouterr().out
        assert out.count("skip train") == 2 and out.count("skip val") == 2
    assert_trees_equal(jax_root, port_root)


def test_coco_semantic_from_panoptic_equal_jax(tmp_path, rng, monkeypatch):
    """COCO panoptic PNGs (ids R + 256 G + 256^2 B, some above 255) and
    their JSON, with category ids that are not contiguous and void pixels
    (id 0) -> contiguous class PNGs, 255 = void."""
    cats = [{"id": c, "name": f"c{c}", "isthing": int(c < 50)} for c in (1, 3, 17, 52, 90, 200)]
    roots = [tmp_path / side / "coco" for side in ("jax", "port")]
    for split, n in (("val2017", 3), ("train2017", 2)):
        anns = []
        for i in range(n):
            h, w = 29 + i, 40 - 3 * i
            ids = rng.choice([0, 1, 300, 70000, 5, 2**20 + 7], size=(h, w))
            segs = [{"id": int(s), "category_id": cats[k % len(cats)]["id"]}
                    for k, s in enumerate(np.unique(ids)) if s]
            anns.append({"image_id": i, "file_name": f"{i:012d}.png", "segments_info": segs})
            for r in roots:
                (r / f"panoptic_{split}").mkdir(parents=True, exist_ok=True)
                write_panoptic_png(str(r / f"panoptic_{split}" / f"{i:012d}.png"), ids)
        for r in roots:
            (r / "annotations").mkdir(exist_ok=True)
            (r / "annotations" / f"panoptic_{split}.json").write_text(
                json.dumps({"annotations": anns, "categories": cats}))
    run_both("prepare_coco_semantic_annos_from_panoptic_annos", *roots, monkeypatch,
             extra=("--workers", "2"))
    assert_trees_equal(*roots)
    with Image.open(roots[1] / "panoptic_semseg_val2017" / f"{0:012d}.png") as im:
        assert set(np.unique(np.asarray(im))) <= {255, 0, 1, 2, 3, 4, 5}
