"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under `alphafold2_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, in
`alphafold2_tpu_torch/_build/` (git-ignored). The library's file name
carries a hash of its source, of every header (`*.cuh`) beside it and of
the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"

# kernel name -> source, relative to the package
SOURCES = {
    "fused_attention": "csrc/fused_attention.cu",
    "block_sparse": "csrc/block_sparse.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = PACKAGE_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one `nvcc` per source, all started together. Returns, per kernel,
    the library path, the build seconds (0.0 when it was already built)
    and the `-Xptxas -v` report (registers, shared memory, spills)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info = {}
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".ptxas.txt")
        if lib.exists():
            info[name] = {"path": str(lib), "seconds": 0.0,
                          "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(PACKAGE_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter(), tmp, lib, log)
    failures = []
    for name, (proc, t0, tmp, lib, log) in procs.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{out}{err}")
            continue
        log.write_text(out + err)
        os.replace(tmp, lib)
        info[name] = {"path": str(lib), "seconds": seconds,
                      "ptxas": out + err}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
