"""BENCHMARK.json and the files it names: names and units, each per-layer
metric's end-to-end metric reported in its cells, the share of four-chip
cells, traffic that a seed fixes, a traced run whose readers read every
host-side metric, and a configuration, a traffic mix, a metric and a cell
added as new files only, found by name."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import time

import pytest
import torch

from port_bench import generator, harness, manifest
from port_bench.tests.tiny import cpu_threads, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def setup_module(module):
    cpu_threads()


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        c = manifest.cell(w["name"])
        assert c.mix["driver"] in ("train", "requests")
        assert set(c.limits)
    for c in BENCH["configs"]:
        assert Path(ROOT / c["file"]).is_file()
        assert json.loads(Path(ROOT / c["file"]).read_text())["source"]
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for w in m.get("workloads", sorted(cells)):
            assert w in cells, (m["name"], w)
            assert manifest.reports(e2e[m["moves"]], w), (m["name"], w)
    for w in cells:
        assert any(manifest.reports(m, w) for m in BENCH["per_layer"]), w
        names = {m["name"] for m in BENCH["end_to_end"] if manifest.reports(m, w)}
        assert "setup_s" in names and len(names) >= 2, w


def test_at_most_a_quarter_of_cells_on_four_chips():
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    four = sum(c == 4 for c in chips)
    assert four <= max(1, len(chips) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traffic_is_fixed_by_the_seed(workload):
    c = tiny_cell(workload)
    if c.mix["driver"] == "train":
        def draw(seed):
            pool = generator.train_pool(c.mix, seed, "cpu", c.config["max_instances"], 80)
            return torch.cat([torch.cat([b[k].float().flatten() for k in sorted(b)])
                              for b in pool])
    else:
        def draw(seed):
            imgs = generator.request_images(c.mix, seed, "cpu")
            order = generator.request_order(c.mix, seed, 3)
            return torch.cat([torch.as_tensor(order, dtype=torch.float32)] +
                             [torch.as_tensor(i).float().flatten() for per in imgs for i in per])
    a, b, other = draw(2 ** 33 + 1), draw(2 ** 33 + 1), draw(2 ** 33 + 2)
    assert torch.equal(a, b)
    assert a.shape != other.shape or not torch.equal(a, other)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reads_every_host_metric(workload):
    """On the CPU the device trace holds nothing, so the readers of device
    time find nothing to read; every other per-layer metric is read."""
    c = tiny_cell(workload)
    r = harness.run_cell(c, 2 ** 33 + 5, 1.0, True, "cpu", time.perf_counter())
    host = {m["name"] for m in c.per_layer if m["source"] != "device_trace"}
    assert host and host <= set(r["metrics"]), (host, r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_every_seed_sends_the_same_work():
    mix = manifest.cell("r50_serve").mix
    a = generator.request_order(mix, 11, 2)
    b = generator.request_order(mix, 12, 2)
    assert sorted(a) == sorted(b) and a != b
    assert [a.count(i) for i in range(len(mix["shapes"]))] == [2 * k for k in mix["per_cycle"]]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_served_model_keeps_its_weights_in_every_run(workload):
    """A served cell's weights follow its configuration, not the run's
    seed (they decide how many panoptic segments the relabelling walks);
    a training run starts from weights of its own seed."""
    c = manifest.cell(workload)
    drivers = [harness.DRIVERS[c.mix["driver"]](c, s, "cpu") for s in (2 ** 33 + 1, 2 ** 33 + 2)]
    seeds = [d.weights_seed for d in drivers]
    if c.mix["driver"] == "requests":
        assert seeds[0] == seeds[1] == generator.sub_seed(0, f"served weights of {c.config_name}")
    else:
        assert seeds == [d.seed for d in drivers]


ADDED = """
import json, sys
from port_bench import manifest
c = manifest.cell("added_cell")
value = manifest.reader("added.metric_ms")({"kind": "train", "stages_ms": {"forward": 7.0}})
print(json.dumps({"config": c.config["preset"], "mix": c.mix["batch"], "limits": c.limits,
                  "value": value, "per_layer": [m["name"] for m in c.per_layer]}))
"""


def test_an_addition_needs_no_edit_of_an_existing_file(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    pb = tmp_path / "port_bench"
    conf = json.loads((pb / "configs" / "coco_instance_r50.json").read_text())
    conf["preset"] = "coco_instance_r101"
    (pb / "configs" / "added_config.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "coco_lsj_train.json").read_text())
    mix["batch"] = 4
    (pb / "traffic" / "added_mix.json").write_text(json.dumps(mix))
    (pb / "cells" / "added_cell.json").write_text(json.dumps({"limits": {"loss_rel": 0.5}}))
    (pb / "metrics" / "added.metric_ms.py").write_text(
        "def read(rec):\n    return rec['stages_ms']['forward'] * 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added_config", "source": "https://example.org/added",
                             "file": "port_bench/configs/added_config.json", "reduced": [],
                             "why": "an added configuration"})
    bench["workloads"].append({"name": "added_cell", "config": "added_config",
                               "traffic": "added_mix", "chips": 1, "why": "an added cell"})
    bench["per_layer"].append({"name": "added.metric_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "network",
                               "moves": "train_images_per_s", "workloads": ["added_cell"]})
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["added_cell"])
                           if m["name"] == "train_images_per_s" else m
                           for m in bench["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # no existing file edited
    out = subprocess.run([sys.executable, "-c", ADDED], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(tmp_path),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "coco_instance_r101" and got["mix"] == 4
    assert got["limits"] == {"loss_rel": 0.5} and got["value"] == 14.0
    assert "added.metric_ms" in got["per_layer"]


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    """Without the system under test the command exits non-zero and prints
    no result."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "r50_serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
