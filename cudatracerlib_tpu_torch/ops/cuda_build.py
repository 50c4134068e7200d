"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel file is one ``csrc/*.cu`` with a plain C interface; the
headers it includes are ``csrc/*.cuh`` (``schedule_probe.cu`` also
includes two kernel files). It is compiled by ``nvcc`` into a shared
library under ``_build/<hash>/``, where the hash covers the source, every
file of ``csrc/`` and the flags, so an edited source or header rebuilds and
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


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC)
                                  if f.endswith((".cu", ".cuh"))):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    return os.path.join(out_dir, os.path.splitext(source)[0] + ".so")


def build(*sources: str) -> None:
    """Compile and load the given ``csrc/`` files that are not loaded yet,
    with one nvcc process for each, all started together. Raises if any
    fails; ``build_log`` records each one's seconds and ptxas report (kept
    beside the library, so that a library built earlier reports it too;
    empty when the report is missing)."""
    t0 = time.perf_counter()
    jobs = {}
    for source in sources:
        if source in _LOADED or source in jobs:
            continue
        lib_path = _lib_path(source)
        proc = tmp = None
        if not os.path.exists(lib_path):
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[source] = (proc, tmp, lib_path)
    failed = []
    for source, (proc, tmp, lib_path) in jobs.items():
        if proc is not None:
            _, ptxas = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source}:\n{ptxas}")
                continue
            with open(lib_path + ".ptxas", "w") as f:
                f.write(ptxas)
            os.replace(tmp, lib_path)
        else:   # built earlier: its report was kept beside it
            try:
                with open(lib_path + ".ptxas") as f:
                    ptxas = f.read()
            except FileNotFoundError:
                ptxas = ""
        _LOADED[source] = ctypes.CDLL(lib_path)
        build_log[source] = dict(seconds=time.perf_counter() - t0,
                                 ptxas=ptxas, path=lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and dlopen it."""
    build(source)
    return _LOADED[source]
