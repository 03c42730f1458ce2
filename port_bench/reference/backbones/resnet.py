"""ResNet as detectron2's R50 builds it for Mask2Former: caffe stem
(7x7/2, max-pool 3x3/2), bottleneck blocks with the stride in the 1x1,
FrozenBN in its folded form (`norm.scale`, `norm.bias`), no conv bias.
Sizes: `depth` (14, 50 or 101)."""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

PORT_NAME = "resnet"
PORT_KEYS = {"depth": "model.backbone.resnet.depth"}

STAGES = {14: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def param_specs(sizes: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, cout, cin, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "fan_in"))
        out.append((f"{name}.norm.scale", (cout,), "one"))
        out.append((f"{name}.norm.bias", (cout,), "zero"))

    conv("backbone.stem.conv1", 64, 3, 7)
    cin, cout, bott = 64, 256, 64
    for si, n in enumerate(STAGES[sizes["depth"]]):
        for b in range(n):
            p = f"backbone.res{si + 2}.{b}"
            conv(f"{p}.conv1", bott, cin, 1)
            conv(f"{p}.conv2", bott, bott, 3)
            conv(f"{p}.conv3", cout, bott, 1)
            if cin != cout:
                conv(f"{p}.shortcut", cout, cin, 1)
            cin = cout
        cout, bott = cout * 2, bott * 2
    return out


def channels(sizes: Mapping) -> Dict[str, int]:
    return {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def forward(x: torch.Tensor, P, sizes: Mapping) -> Dict[str, torch.Tensor]:
    def conv_bn(x, name, stride=1, k=1):
        y = F.conv2d(x, P[f"{name}.weight"], stride=stride, padding=(k - 1) // 2)
        return y * P[f"{name}.norm.scale"][:, None, None] + P[f"{name}.norm.bias"][:, None, None]

    x = F.relu(conv_bn(x, "backbone.stem.conv1", 2, 7))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = {}
    for si, n in enumerate(STAGES[sizes["depth"]]):
        for b in range(n):
            p = f"backbone.res{si + 2}.{b}"
            stride = 2 if (b == 0 and si > 0) else 1
            y = F.relu(conv_bn(x, f"{p}.conv1", stride))
            y = F.relu(conv_bn(y, f"{p}.conv2", 1, 3))
            y = conv_bn(y, f"{p}.conv3")
            sc = conv_bn(x, f"{p}.shortcut", stride) if f"{p}.shortcut.weight" in P else x
            x = F.relu(y + sc)
        feats[f"res{si + 2}"] = x
    return feats
