"""Zoo-parity regression runner: one command from a reference checkpoint
and a data root to asserted AP / PQ / mIoU (the analogue of the reference's
`verify_results(cfg, res)` gate driven by TEST.EXPECTED_RESULTS,
train_net.py:317; the published numbers are the model zoo's, MODEL_ZOO.md
and BASELINE.md). The JAX package's tools/zoo_parity.py, on the port.

    python -m bm2f_tpu_torch.tools.zoo_parity --config coco_instance_r50 \\
        --dataset coco_2017_val --weights model_final_3c8ec9.pkl \\
        --data-root /data/datasets            # expects mask AP 43.7 +- 0.3

    # explicit expectations / tolerance / subset:
    python -m bm2f_tpu_torch.tools.zoo_parity --config coco_panoptic_r50 \\
        --dataset coco_2017_val_panoptic --weights model_final_94dc52.pkl \\
        --expected PQ=51.9 --tolerance 0.5 --max-images 500

--weights takes what `utils.convert_weights.load_weights` takes: a
detectron2 .pkl / .pth, a checkpoint directory of the port, or an orbax
directory of the JAX package; '' is the random init from seed 0 (the JAX
tool's PRNGKey(0)), for wiring runs. Exit code 0 iff every expected metric is within tolerance,
and always 0 with --no-assert. With no --expected, the built-in zoo table
below supplies the preset's published numbers (full-dataset single-scale
protocol: pass --max-images only for smoke runs, with --no-assert or a
wide tolerance). Under `torch.distributed` each rank evaluates its share
and the evaluator's state is gathered. Runs on the card unless --device
cpu (the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys

from bm2f_tpu_torch.config import parse_override

# checkpoint id -> metrics: the reference's MODEL_ZOO.md (see BASELINE.md)
ZOO_EXPECTED = {
    "coco_instance_r50": {"AP": 43.7},
    "coco_instance_r101": {"AP": 44.2},
    "coco_instance_swin_l": {"AP": 50.1},
    "coco_panoptic_r50": {"PQ": 51.9},
    "coco_panoptic_r101": {"PQ": 52.6},
    "coco_panoptic_swin_l": {"PQ": 57.8},
    "ade20k_semantic_r50": {"mIoU": 47.2},
    "ade20k_panoptic_r50": {"PQ": 39.7},
    "ade20k_instance_r50": {"AP": 26.4},
    "cityscapes_semantic_r50": {"mIoU": 79.4},
    "ytvis2019_video_r50": {"AP": 46.4},
    "ytvis2021_video_r50": {"AP": 40.6},
}


def load_model(cfg, weights: str, device="cuda"):
    """The preset's model (the video model for a video preset) on `device`
    with `weights` loaded strictly ('' = the random init from seed 0), its
    weights cast once for inference."""
    if cfg.task == "video":
        from bm2f_tpu_torch.video import build_video_model as build
    else:
        from bm2f_tpu_torch.models import build_model as build

    model = build(cfg, device=device, seed=0)
    if weights:
        from bm2f_tpu_torch.utils.convert_weights import load_weights

        model.load_state_dict(load_weights(weights, cfg), strict=True)
    return model.cast_weights_for_inference_()


def zoo_parity(cfg_name: str, dataset: str, weights: str = "",
               expected=None, tolerance: float = 0.3, max_images: int = 0,
               cfg_overrides=None, device="cuda"):
    """Load -> eval -> verify. Returns (results, ok): whether every
    expected metric is within `tolerance`."""
    from bm2f_tpu_torch.config import get_config
    from bm2f_tpu_torch.evaluation.evaluator import verify_results

    cfg = get_config(cfg_name, cfg_overrides or {})
    model = load_model(cfg, weights, device)
    if cfg.task == "video":
        from bm2f_tpu_torch.eval_video import run_video_eval

        results = run_video_eval(cfg, model, dataset, max_videos=max_images)
    else:
        from bm2f_tpu_torch.eval import run_eval

        results = run_eval(cfg, model, dataset, max_images)

    if expected is None:
        expected = ZOO_EXPECTED.get(cfg_name)
    if not expected:
        print(f"# no expected metrics for preset {cfg_name!r}; skipping gate")
        return results, True
    return results, verify_results(expected, results, tolerance=tolerance)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--weights", default="",
                    help="d2 .pkl/.pth, a port checkpoint dir or an orbax dir")
    ap.add_argument("--data-root", default="",
                    help="dataset root (sets $DETECTRON2_DATASETS)")
    ap.add_argument("--expected", default="",
                    help="comma list k=v, e.g. 'AP=43.7,AP50=65.0'; defaults "
                         "to the built-in zoo table for the preset")
    ap.add_argument("--tolerance", type=float, default=0.3)
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--no-assert", action="store_true",
                    help="report, but always exit 0 (smoke runs)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain versions)")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE", help="a config override (a Python literal)")
    args = ap.parse_args(argv)

    from bm2f_tpu_torch.tools.device import tool_device

    dev = tool_device("zoo_parity", args.device)
    if args.data_root:
        os.environ["DETECTRON2_DATASETS"] = args.data_root

    from bm2f_tpu_torch.data.cityscapes import register_all_cityscapes
    from bm2f_tpu_torch.data.datasets import register_all_builtin_datasets
    from bm2f_tpu_torch.data.ytvis import register_all_ytvis

    register_all_builtin_datasets()
    register_all_cityscapes()
    register_all_ytvis()

    expected = None
    if args.expected:
        expected = {k: float(v) for k, v in (kv.split("=") for kv in args.expected.split(","))}

    results, ok = zoo_parity(args.config, args.dataset, args.weights, expected,
                             args.tolerance, args.max_images,
                             cfg_overrides=dict(args.set), device=dev)
    print({k: round(v, 2) for k, v in results.items()})
    return 0 if ok or args.no_assert else 1


if __name__ == "__main__":
    sys.exit(main())
