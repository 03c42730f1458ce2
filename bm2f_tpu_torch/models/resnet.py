"""ResNet backbone (detectron2-compatible R14/R50/R101), NCHW.

Mirrors detectron2's builtin `build_resnet_backbone` used by the reference's
Base-*.yaml configs: caffe-style MSRA weights, FrozenBN, STRIDE_IN_1X1=True,
conv bias=False. Keys follow detectron2 (`backbone.stem.conv1`,
`backbone.res2.0.conv1`, `backbone.res2.0.shortcut`, ...). Output features:
res2 (stride 4) .. res5 (stride 32).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bm2f_tpu_torch.models.layers import Conv2d, FrozenBatchNorm

# (num_blocks per stage) for each depth; 14 = one bottleneck per stage
# (test-size model — same channel plan and feature strides as R50)
RESNET_STAGES = {
    14: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}
RESNET_FEATURE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
RESNET_FEATURE_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                  bias=False, norm=FrozenBatchNorm(cout))


class BasicStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv_bn(3, 64, 7, 2)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        # MaxPool2d(3, 2, padding=1) pads with -inf
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int):
        super().__init__()
        # stride_in_1x1: the stride sits on conv1, not on the 3x3
        self.conv1 = _conv_bn(cin, bottleneck, 1, stride)
        self.conv2 = _conv_bn(bottleneck, bottleneck, 3)
        self.conv3 = _conv_bn(bottleneck, cout, 1)
        self.shortcut = _conv_bn(cin, cout, 1, stride) if cin != cout else None

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + sc)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = BasicStem()
        self.stage_names = []
        cin, cout, bott = 64, 256, 64
        for si, n in enumerate(RESNET_STAGES[depth]):
            name = f"res{si + 2}"
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and si > 0) else 1
                blocks.append(BottleneckBlock(cin, bott, cout, stride))
                cin = cout
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            cout *= 2
            bott *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outs[name] = x
        return outs
