"""Build the port's hand-written CUDA kernels with `nvcc`, and its host C++
sources (`*.cpp`: the LAP solver) with the host compiler, and load them with
`ctypes`.

Each source under `bm2f_tpu_torch/csrc/` exports plain C functions (no
PyTorch headers), so one compiler call per file takes seconds. Libraries go
to `bm2f_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of the
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
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cxx_path() -> str:
    """The host C++ compiler: $CXX, else c++ or g++ on PATH."""
    for cand in (os.environ.get("CXX", ""), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found to build "
                       "bm2f_tpu_torch/csrc/*.cpp: set CXX or put one on PATH")


def _flags(source) -> Tuple[str, ...]:
    return CXX_FLAGS if str(source).endswith(".cpp") else NVCC_FLAGS


def _compiler(source) -> list:
    """The compiler and its flags for one source: `.cpp` on the host
    compiler, everything else with `nvcc`."""
    cc = cxx_path() if str(source).endswith(".cpp") else nvcc_path()
    return [cc, *_flags(source)]


def library_path(source: str) -> Path:
    """Named by a hash of the source, every header under `csrc/` (a source
    may include any of them) and the flags, so that an edit to a shared
    header never loads a stale library."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


def _compile(jobs) -> Dict[str, Tuple[Path, float, str]]:
    """jobs: {key: (source path, library path)}. Compiles every library not
    yet built, one compiler process each, all started together. Returns {key:
    (library, seconds, compiler log)}; raises if any compile fails."""
    procs, result = {}, {}
    for key, (src, lib) in jobs.items():
        if lib.exists():
            result[key] = (lib, 0.0, "cached")
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [*_compiler(src), "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib, tmp, time.perf_counter())
    failed = []
    for key, (proc, lib, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{key} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        result[key] = (lib, seconds, log)
    if failed:
        raise RuntimeError("compile failed for " + "\n".join(failed))
    return result


def build(sources: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every source not yet built, one compiler process each, all
    started together. Returns {source: (library, seconds, compiler log)};
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _compile({s: (CSRC_DIR / s, library_path(s)) for s in sources})


def build_variants(specs) -> Dict[object, ctypes.CDLL]:
    """specs: {label: source path}, sources outside `csrc/` (for instance a
    parent commit's, unpacked elsewhere) built into `_build/variants/`, all
    in parallel. Returns {label: loaded library}."""
    jobs = {}
    for label, src in specs.items():
        src = Path(src)
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(src.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(_flags(src)).encode())
        lib = BUILD_DIR / "variants" / f"{src.stem}-{h.hexdigest()[:16]}.so"
        jobs[label] = (src, lib)
    return {label: ctypes.CDLL(str(lib)) for label, (lib, _, _) in _compile(jobs).items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _loaded:
        lib, _, _ = build([source])[source]
        _loaded[source] = ctypes.CDLL(str(lib))
    return _loaded[source]
