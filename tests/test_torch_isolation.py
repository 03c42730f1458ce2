"""The port and its chip smoke script import nothing of JAX, Flax or the
JAX package: checked in a fresh interpreter after importing every module."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import bm2f_tpu_torch
for m in pkgutil.walk_packages(bm2f_tpu_torch.__path__, "bm2f_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "bm2f_tpu"))
print("FORBIDDEN", bad)
print("IMPORTED", len([n for n in sys.modules if n.startswith("bm2f_tpu_torch")]))
print("MODULES", " ".join(sorted(n for n in sys.modules if n.startswith("bm2f_tpu_torch"))))
"""

# the video slice's modules, which the walk must reach
VIDEO_MODULES = ("bm2f_tpu_torch.video.video_decoder", "bm2f_tpu_torch.video.video_maskformer",
                 "bm2f_tpu_torch.eval_video", "bm2f_tpu_torch.data.ytvis",
                 "bm2f_tpu_torch.evaluation.ytvis_eval", "bm2f_tpu_torch.losses.video_criterion",
                 "bm2f_tpu_torch.losses.weaksup_video")


# the entry points and MaskFormer-v1 modules, which the walk must reach
ENTRY_AND_V1_MODULES = ("bm2f_tpu_torch.demo", "bm2f_tpu_torch.demo_video",
                        "bm2f_tpu_torch.models.tta", "bm2f_tpu_torch.models.transformer",
                        "bm2f_tpu_torch.models.maskformer_v1", "bm2f_tpu_torch.utils.memory",
                        "bm2f_tpu_torch.utils.async_predictor")


# the data-parallel modules, which the walk must reach
PARALLEL_MODULES = ("bm2f_tpu_torch.parallel", "bm2f_tpu_torch.parallel.mesh")


# the root tools and point_features, which the walk must reach
TOOLS_MODULES = tuple(f"bm2f_tpu_torch.tools.{name}" for name in (
    "analyze_model", "convert_torchvision_weights", "evaluate_coco_boundary_ap",
    "evaluate_pq_for_semantic_segmentation", "prepare_ade20k_ins_seg",
    "prepare_ade20k_pan_seg", "prepare_ade20k_sem_seg",
    "prepare_coco_semantic_annos_from_panoptic_annos", "zoo_parity", "profile_criterion",
    "profile_forward", "profile_kernel", "device")) + ("bm2f_tpu_torch.losses.point_features",)


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout
    n = int(res.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 15, res.stdout
    modules = res.stdout.split("MODULES")[1].split()
    assert set(VIDEO_MODULES) <= set(modules), res.stdout
    assert set(ENTRY_AND_V1_MODULES) <= set(modules), res.stdout
    assert set(PARALLEL_MODULES) <= set(modules), res.stdout
    assert set(TOOLS_MODULES) <= set(modules), res.stdout
