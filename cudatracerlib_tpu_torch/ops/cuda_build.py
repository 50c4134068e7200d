"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled by ``nvcc`` into a shared library under ``_build/<hash>/``, where
the hash covers the source and the flags, so an edited source rebuilds and
an unchanged one loads at once. Nothing here runs at import time; a missing
``nvcc`` raises when a kernel is first needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict = {}
build_log: dict = {}   # source name -> dict(seconds, ptxas, path)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and dlopen it."""
    if source in _LOADED:
        return _LOADED[source]
    path = os.path.join(CSRC, source)
    with open(path, "rb") as f:
        text = f.read()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, key)
    lib_path = os.path.join(out_dir, os.path.splitext(source)[0] + ".so")
    t0 = time.perf_counter()
    ptxas = ""
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        ptxas = proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    build_log[source] = dict(seconds=time.perf_counter() - t0, ptxas=ptxas,
                             path=lib_path)
    _LOADED[source] = lib
    return lib
