"""Build a CUDA source of ``repro_torch/csrc`` with nvcc and load it via ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under the
git-ignored ``build/kernels`` directory at the repository root. The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU tests import the kernel modules on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile 0: optimize a source's kernels on every core at once (the
# attention sources hold tens of template instantiations each)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0"]

_LOADED: dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": load wall time, build included, "log": nvcc's
# stderr (empty if the library was already built), which carries ptxas'
# register / shared-memory / spill report}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are built from source at first use")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
        log = proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    _LOADED[name] = lib
    return lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """``load`` several sources at once: one nvcc process per source, all
    started together (each build releases the GIL while nvcc runs)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
