"""Build the port's hand-written CUDA kernels with `nvcc` and load them with
`ctypes`.

Each source under `bm2f_tpu_torch/csrc/` exports plain C functions (no
PyTorch headers), so one `nvcc` call per file takes seconds. Libraries go to
`bm2f_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of the
source, the shared headers and the flags, and are built at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    """Named by a hash of the source, every header under `csrc/` (a source
    may include any of them) and the flags, so that an edit to a shared
    header never loads a stale library."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


def build(sources: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every source not yet built, one `nvcc` process each, all
    started together. Returns {source: (library, seconds, compiler log)};
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            result[source] = (lib, 0.0, "cached")
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib, tmp, time.perf_counter())
    failed = []
    for source, (proc, lib, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        result[source] = (lib, seconds, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _loaded:
        lib, _, _ = build([source])[source]
        _loaded[source] = ctypes.CDLL(str(lib))
    return _loaded[source]
