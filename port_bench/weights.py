"""Seeded weights, made by the benchmark on the run's device.

One `torch.randn` call on a seeded generator draws every random weight
at once (a training run seeds it from `--seed`; a served cell from its
configuration's name, the same in every run: `harness.ServeDriver`),
then each weight takes its scale by kind (`reference.model.param_specs`):

- "fan_in": N(0, 1 / fan_in) (a LeCun normal: every product keeps its
  input's scale, so no width's activations vanish or blow up at depth);
- "class": N(0, 25 / fan_in), so that class logits spread by about 5 and
  some queries are confidently one class, as a trained model's are: the
  panoptic fusion keeps a query only above a score of 0.8;
- "embed": N(0, 1);
- "one", "zero": constants; "ring": upstream's sampling-offset bias;
- a kind of the backbone file's `KINDS` (kind -> std): N(0, std^2), as
  upstream's `trunc_normal_(std=0.02)` draws a bias table (its cut at +-2
  lies 100 std out).

The same dict is loaded into the system under test (`load_state_dict`)
and handed to the plain reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from port_bench.reference.model import Arch, param_specs, ring_bias

RANDOM_KINDS = ("fan_in", "class", "embed")
CLASS_GAIN = 5.0


def make_weights(a: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    specs: List[Tuple[str, Tuple[int, ...], str]] = param_specs(a)
    std = getattr(a.net, "KINDS", {})
    random = set(RANDOM_KINDS) | set(std)
    gen = torch.Generator(device=device).manual_seed(seed_bits(seed))
    sizes = [int(torch.Size(shape).numel()) for _, shape, kind in specs if kind in random]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    chunks = iter(flat.split(sizes))
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind in specs:
        if kind in std:
            w = next(chunks).view(shape) * std[kind]
        elif kind in RANDOM_KINDS:
            w = next(chunks).view(shape)
            if kind != "embed":
                fan_in = int(torch.Size(shape[1:]).numel())
                w = w * ((CLASS_GAIN if kind == "class" else 1.0) / fan_in ** 0.5)
        elif kind == "one":
            w = torch.ones(shape, device=device)
        elif kind == "zero":
            w = torch.zeros(shape, device=device)
        elif kind == "ring":
            w = ring_bias(a.enc_heads, 3, a.enc_points).to(device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = w
    return out


def seed_bits(seed: int) -> int:
    """A seed folded into the 63 bits a torch generator takes."""
    return int(seed) % (2 ** 63 - 1)
