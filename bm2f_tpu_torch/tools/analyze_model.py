"""Model analysis: the parameter table and the forward's FLOPs of a preset
(reference: tools/analyze_model.py, fvcore's parameter_count and
FlopCountAnalysis; the JAX package's tool of that name).

    python -m bm2f_tpu_torch.tools.analyze_model --config coco_instance_r50 \\
        --size 800 [--batch 1] [--tasks params,flops] [--device cuda]

The parameter table is the JAX tool's, line for line: the total, and the
25 largest groups by the first two components of the JAX package's
parameter path (`backbone/res2_block0`, `sem_seg_head/pixel_decoder`, ...;
ties in the order of the paths). It counts what the JAX tool counts, the
leaves of `variables["params"]`: the port's parameters, each named by its
JAX group. The ResNet's FrozenBN statistics are buffers here and live in
the JAX package's `frozen` collection, so neither side counts them.

The FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of one
forward on zero images: matrix products and convolutions, a multiply-add
counted as 2. The deformable sampling (K1) is a kernel launched through
ctypes, which the counter cannot see; its plain version is products the
counter would count. So each call of the deformable core is counted
apart, from its shapes: 2 FLOPs per corner, channel and sample, all four
bilinear corners of the B*Q*M*L*P samples (what the plain version's
product does), and whatever the counter saw inside the call is left out.
The kernel path and the plain path therefore report the same FLOPs.
Each run of the core is also counted where it runs (a K1 launch, or the
plain version inside `ms_deform_attn`); a run that the pixel decoder's
calls do not account for raises, so no other caller goes uncounted. XLA's
`cost_analysis`, which the JAX tool prints, also counts elementwise work:
the two conventions differ, and their numbers are not comparable.

Runs on the card unless --device cpu (the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import re
from collections import defaultdict
from typing import Dict, Tuple
from unittest import mock

import torch

# the port's parameter names -> the JAX package's group (the first two
# components of its parameter path); Swin's stages of even depth are scanned
# in block pairs there (`stage{s}_pairs`), the others unrolled
_GROUP_RULES = (
    (r"backbone\.stem\..+", lambda m, even: "backbone/stem_conv1"),
    (r"backbone\.res(\d)\.(\d+)\..+", lambda m, even: f"backbone/res{m[1]}_block{m[2]}"),
    (r"backbone\.patch_embed\.(proj|norm)\..+", lambda m, even: f"backbone/patch_embed_{m[1]}"),
    (r"backbone\.layers\.(\d+)\.blocks\.(\d+)\..+", lambda m, even: (
        f"backbone/stage{m[1]}_pairs" if even[int(m[1])] else
        f"backbone/stage{m[1]}_block{m[2]}")),
    (r"backbone\.layers\.(\d+)\.downsample\..+", lambda m, even: f"backbone/downsample{m[1]}"),
    (r"backbone\.norm(\d+)\..+", lambda m, even: f"backbone/out_norm{m[1]}"),
    (r"backbone\.absolute_pos_embed", lambda m, even: "backbone/absolute_pos_embed"),
    (r"sem_seg_head\.(pixel_decoder|predictor)\..+", lambda m, even: f"sem_seg_head/{m[1]}"),
)


def jax_group(name: str, even_stages: Dict[int, bool]) -> str:
    """The JAX package's group of the port's parameter `name`."""
    for pattern, group in _GROUP_RULES:
        m = re.fullmatch(pattern, name)
        if m:
            return group(m, even_stages)
    raise KeyError(f"no JAX parameter group for {name!r}")


def param_table(model: torch.nn.Module) -> Tuple[int, Dict[str, int]]:
    """(total, {JAX group: count}) of the model's parameters, the groups in
    the order the JAX tool meets them (its paths, sorted)."""
    names = dict(model.named_parameters())
    blocks = defaultdict(set)
    for n in names:
        m = re.fullmatch(r"backbone\.layers\.(\d+)\.blocks\.(\d+)\..+", n)
        if m:
            blocks[int(m[1])].add(int(m[2]))
    even = {s: len(b) % 2 == 0 for s, b in blocks.items()}
    groups: Dict[str, int] = defaultdict(int)
    for n, p in names.items():
        groups[jax_group(n, even)] += p.numel()
    ordered = {k: groups[k] for k in sorted(groups, key=lambda k: tuple(k.split("/")))}
    return sum(ordered.values()), ordered


def print_param_table(total: int, groups: Dict[str, int]) -> None:
    print(f"total params: {total/1e6:.2f} M")
    for k in sorted(groups, key=groups.get, reverse=True)[:25]:
        print(f"  {k:60s} {groups[k]/1e6:8.3f} M")


def k1_flops(value: torch.Tensor, sampling_locations: torch.Tensor) -> int:
    """The deformable core's FLOPs from its shapes: value (B, S, M, D),
    locations (B, Q, M, L, P, 2); a multiply-add for each of the 4 corners
    of each sample and channel."""
    B, Q, M, L, P, _ = sampling_locations.shape
    return 2 * 4 * B * Q * M * L * P * value.shape[-1]


def forward_flops(model, images: torch.Tensor, model_cfg) -> Tuple[int, int]:
    """(products and convolutions outside the deformable core, the core's
    own count) of one forward of `model` on `images` (B, H, W, 3). The core
    is counted at the pixel decoder's calls; every run of the core itself
    (a K1 launch, or its plain version inside `ms_deform_attn`) is counted
    too, and a run that came from elsewhere raises instead of going
    uncounted."""
    from torch.utils.flop_counter import FlopCounterMode

    from bm2f_tpu_torch.models import pixel_decoder
    from bm2f_tpu_torch.models.maskformer import normalize_images
    from bm2f_tpu_torch.ops import deform_attn

    k1 = [0, 0]  # the core's count, what the counter saw inside it
    calls = {"counted": 0, "core": 0}

    def counted(fn, key=None):
        def call(value, spatial_shapes, sampling_locations, attention_weights):
            if key:
                calls[key] += 1
            k1[0] += k1_flops(value, sampling_locations)
            with FlopCounterMode(display=False) as inner:
                out = fn(value, spatial_shapes, sampling_locations, attention_weights)
            k1[1] += inner.get_total_flops()
            return out
        return call

    def core(fn):
        def run(*args):
            calls["core"] += 1
            return fn(*args)
        return run

    with contextlib.ExitStack() as stack:
        for name, key in (("ms_deform_attn", "counted"), ("ms_deform_attn_plain", None)):
            stack.enter_context(mock.patch.object(
                pixel_decoder, name, counted(getattr(pixel_decoder, name), key)))
        for name in ("launch_fwd", "ms_deform_attn_plain"):
            stack.enter_context(mock.patch.object(
                deform_attn, name, core(getattr(deform_attn, name))))
        stack.enter_context(torch.no_grad())
        counter = stack.enter_context(FlopCounterMode(display=False))
        model(normalize_images(images, model_cfg))
    if calls["core"] != calls["counted"]:
        raise RuntimeError(
            f"analyze_model: the deformable core ran {calls['core']} times but "
            f"{calls['counted']} calls were counted at the pixel decoder; a caller "
            "elsewhere would have its K1 term missed")
    return counter.get_total_flops() - k1[1], k1[0]


def main(argv=None) -> dict:
    from bm2f_tpu_torch.config import get_config, parse_override
    from bm2f_tpu_torch.models import build_model
    from bm2f_tpu_torch.tools.device import tool_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="coco_instance_r50")
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--tasks", default="params,flops", help="comma list: params,flops")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (plain versions)")
    ap.add_argument("--set", action="append", default=[], type=parse_override,
                    metavar="KEY=VALUE", help="a config override (a Python literal)")
    args = ap.parse_args(argv)

    dev = tool_device("analyze_model", args.device)
    cfg = get_config(args.config, dict(args.set))
    model = build_model(cfg, device=dev, seed=0).eval().requires_grad_(False)

    tasks = args.tasks.split(",")
    res = {}
    if "params" in tasks:
        res["params"], res["groups"] = param_table(model)
        print_param_table(res["params"], res["groups"])
    if "flops" in tasks:
        imgs = torch.zeros((args.batch, args.size, args.size, 3), device=dev)
        res["flops"], res["k1_flops"] = forward_flops(model, imgs, cfg.model)
        print(f"forward FLOPs (products and convolutions, batch={args.batch}): "
              f"{res['flops']/1e9:.3f} G")
        print(f"deformable sampling (K1, from its shapes): {res['k1_flops']/1e9:.3f} G")
        print(f"total: {(res['flops'] + res['k1_flops'])/1e9:.3f} G")
    return res


if __name__ == "__main__":
    main()
