"""Convert torchvision ResNet and timm (or official) Swin ImageNet weights
into a detectron2-named backbone checkpoint (reference:
tools/convert-torchvision-to-d2.py and convert-pretrained-swin-model-to-d2.py;
the JAX package's tools/convert_torchvision_weights.py writes the same
pickle). The port reads it with `utils.convert_weights.load_d2_state_dict`
/ `load_weights`, which fold the ResNet's batch-norm statistics into
FrozenBN.

    python -m bm2f_tpu_torch.tools.convert_torchvision_weights resnet50.pth R-50.pkl --arch resnet50
    python -m bm2f_tpu_torch.tools.convert_torchvision_weights swin_large.pth swin_l.pkl --arch swin

The pickle holds {"model": {name: numpy array}, "__author__": ...}: the
backbone only. A Swin checkpoint keeps its final `norm` (detectron2's
backbone has per-stage output norms `norm0..3` instead, which ImageNet
weights do not carry) and drops its classifier `head`.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def convert_torchvision_resnet(sd):
    """torchvision names (conv1, bn1, layerX.Y.convZ/bnZ/downsample) ->
    detectron2 names (backbone.stem.conv1, backbone.resN.B.convZ.norm, ...)."""
    out = {}
    out["backbone.stem.conv1.weight"] = sd["conv1.weight"]
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"backbone.stem.conv1.norm.{k}"] = sd[f"bn1.{k}"]
    for layer in range(1, 5):
        b = 0
        while f"layer{layer}.{b}.conv1.weight" in sd:
            src = f"layer{layer}.{b}"
            dst = f"backbone.res{layer + 1}.{b}"
            for c in (1, 2, 3):
                out[f"{dst}.conv{c}.weight"] = sd[f"{src}.conv{c}.weight"]
                for k in ("weight", "bias", "running_mean", "running_var"):
                    out[f"{dst}.conv{c}.norm.{k}"] = sd[f"{src}.bn{c}.{k}"]
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.shortcut.weight"] = sd[f"{src}.downsample.0.weight"]
                for k in ("weight", "bias", "running_mean", "running_var"):
                    out[f"{dst}.shortcut.norm.{k}"] = sd[f"{src}.downsample.1.{k}"]
            b += 1
    return out


def convert_timm_swin(sd):
    """timm / official Swin names -> detectron2 'backbone.*' names."""
    return {"backbone." + k: v for k, v in sd.items() if not k.startswith("head.")}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--arch", default="resnet50", choices=["resnet50", "resnet101", "swin"])
    args = ap.parse_args(argv)

    import torch

    data = torch.load(args.src, map_location="cpu", weights_only=False)
    sd = data.get("model", data.get("state_dict", data))
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()
          if isinstance(v, (torch.Tensor, np.ndarray))}

    d2sd = convert_torchvision_resnet(sd) if args.arch.startswith("resnet") else (
        convert_timm_swin(sd))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"model": d2sd, "__author__": "bm2f_tpu_torch"}, f)
    print(f"wrote {len(d2sd)} tensors to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
