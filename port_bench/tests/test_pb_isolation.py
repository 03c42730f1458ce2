"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the system under test. Each check runs in a
fresh interpreter, so that what the test process itself imported does not
count; module names are compared by their top-level name, whole (the
port's name, `bm2f_tpu_torch`, begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = ["jax", "jaxlib", "flax", "bm2f_tpu"]

LOADED = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""


def top_level_after(body: str) -> set:
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "HOME": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", LOADED.format(body=body)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_traffic_metrics_and_a_run_load_no_jax():
    body = """
import torch
torch.set_num_threads(2)
import port_bench.run, port_bench.harness, port_bench.generator, port_bench.calibrate
from port_bench import manifest
bench = manifest.benchmark()
for m in bench["per_layer"]:
    manifest.reader(m["name"])
import time
from port_bench import harness
from port_bench.tests.tiny import tiny_cell
for w in [w["name"] for w in bench["workloads"]]:
    harness.run_cell(tiny_cell(w), 5, 0.5, False, "cpu", time.perf_counter())
"""
    loaded = top_level_after(body)
    assert "bm2f_tpu_torch" in loaded  # the run did drive the port
    assert not loaded & set(BANNED), sorted(loaded & set(BANNED))


def test_reference_loads_nothing_of_the_port():
    body = """
import port_bench.reference.model, port_bench.reference.criterion, port_bench.reference.weak
import port_bench.reference.optim, port_bench.reference.train, port_bench.reference.serve
import port_bench.reference.numerics
"""
    loaded = top_level_after(body)
    assert not loaded & {"bm2f_tpu_torch", *BANNED}, sorted(loaded & {"bm2f_tpu_torch", *BANNED})


def test_run_refuses_a_banned_module(monkeypatch):
    from port_bench.run import loaded_banned

    monkeypatch.setitem(sys.modules, "bm2f_tpu_torch_probe.sub", sys)
    assert "bm2f_tpu" not in loaded_banned()  # a name that begins with it is not it
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "bm2f_tpu.models", sys)
    assert {"jax", "bm2f_tpu"} <= set(loaded_banned())
