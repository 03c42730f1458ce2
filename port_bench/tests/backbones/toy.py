"""A backbone for the tests of the lookup: one strided convolution per
level, each followed by a per-channel table of a weight kind of its own
(N(0, 0.02^2)) and a ReLU. Sizes: `width`, the channels of `res2`, doubled
at each level after it. Its levels are dataclasses, which need the module
in `sys.modules`."""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F

PORT_NAME = "toy"
PORT_KEYS = {"width": "model.backbone.toy.width"}
KINDS = {"toy_table": 0.02}


@dataclass(frozen=True)
class Level:
    name: str
    stride: int


LEVELS = (Level("res2", 4), Level("res3", 2), Level("res4", 2), Level("res5", 2))
STRIDES = {lv.name: lv.stride for lv in LEVELS}


def channels(sizes):
    return {lvl: sizes["width"] * 2 ** i for i, lvl in enumerate(STRIDES)}


def param_specs(sizes):
    ch, cin, out = channels(sizes), 3, []
    for lvl, s in STRIDES.items():
        out.append((f"backbone.{lvl}.weight", (ch[lvl], cin, s, s), "fan_in"))
        out.append((f"backbone.{lvl}.table", (ch[lvl],), "toy_table"))
        cin = ch[lvl]
    return out


def forward(x, P, sizes):
    feats = {}
    for lvl, s in STRIDES.items():
        x = F.relu(F.conv2d(x, P[f"backbone.{lvl}.weight"], stride=s)
                   + P[f"backbone.{lvl}.table"][:, None, None])
        feats[lvl] = x
    return feats
