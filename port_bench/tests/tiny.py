"""The benchmark's cells at a small size, for the tests on the CPU: each
cell's configuration and traffic from its files, with `tiny.json`'s
overrides (a ResNet-14 head of one encoder and three decoder layers, ten
queries, images of about 100 pixels)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from port_bench import manifest

HERE = Path(__file__).resolve().parent
TINY = json.loads((HERE / "tiny.json").read_text())
TRAFFIC_OF = {"coco_lsj_train": "train", "coco_wo_lsj_boxsup_train": "boxsup",
              "coco_test_requests": "requests"}


def tiny_cell(workload: str, limits=None) -> manifest.Cell:
    """A cell of BENCHMARK.json at the small size."""
    c = shrink(manifest.cell(workload))
    if limits is not None:
        c.limits = limits
    return c


def tiny_cell_of(config: str, traffic: str, limits_of: str) -> manifest.Cell:
    """A cell BENCHMARK.json does not list, from its configuration and
    traffic files, with the limits of the cell `limits_of`."""
    c = manifest.cell(limits_of)
    c.name, c.config_name, c.traffic_name = f"{config}.{traffic}", config, traffic
    c.config = manifest.load_json(manifest.HERE / "configs" / f"{config}.json")
    c.mix = manifest.load_json(manifest.HERE / "traffic" / f"{traffic}.json")
    return shrink(c)


def shrink(c: manifest.Cell) -> manifest.Cell:
    conf = copy.deepcopy(c.config)
    conf["overrides"] = {**conf["overrides"], **TINY["overrides"]}
    conf["arch"].update(TINY["arch"])
    conf["loss"].update(TINY["loss"])
    conf["max_instances"] = TINY["max_instances"]
    c.config = conf
    c.mix = {**c.mix, **TINY["traffic"][TRAFFIC_OF[c.traffic_name]]}
    return c


def cpu_threads() -> None:
    torch.set_num_threads(2)
