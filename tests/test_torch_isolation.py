"""The port and its chip smoke script import nothing of JAX, Flax or the
JAX package: checked in a fresh interpreter after importing every module."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import bm2f_tpu_torch
for m in pkgutil.walk_packages(bm2f_tpu_torch.__path__, "bm2f_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "bm2f_tpu"))
print("FORBIDDEN", bad)
print("IMPORTED", len([n for n in sys.modules if n.startswith("bm2f_tpu_torch")]))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout
    n = int(res.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 15, res.stdout
