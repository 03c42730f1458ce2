"""Finds everything by name: `BENCHMARK.json` at the root of the checkout
names each cell's configuration, traffic mix and chips, and each metric;
each of those is a file of its own under `port_bench/`:

- `configs/<config>.json`: the configuration as it is run;
- `traffic/<mix>.json`: the mix's parameters, read by `generator.py`;
- `cells/<workload>.json`: the cell's limits on the numbers that decide
  `correct`, with the readings they were set from;
- `metrics/<metric>.py`: a reader with `read(records) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: Mapping, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: Optional[Mapping] = None, base: Path = HERE) -> Cell:
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=load_json(base / "configs" / f"{w['config']}.json"),
        mix=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "cells" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if reports(m, workload)])


def reader(metric: str, base: Path = HERE) -> Callable[[Mapping], Optional[float]]:
    """`read` of `metrics/<metric>.py` (a metric's name may hold dots, so the
    file is loaded by its path)."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
