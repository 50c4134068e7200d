"""The native BVH8 builder (``native/bvh_builder.cpp``) through ctypes.

Port of ``cudatracerlib_tpu/scene/native_bvh.py``. The port compiles its own
copy of the library from the repository's source with the Makefile's flags,
into ``_build/<hash>/`` (the hash covers the source, the flags and the
host CPU, since ``-march=native`` ties the library to it), at first use,
and never writes to ``native/``. It keeps no disk cache of finished
builds. A build of 4,096 or more triangles raises when the library cannot be
built or fails: the numpy builder makes another BVH, and at a million
triangles it would run for minutes. ``scene/host.py`` calls it from 4,096
triangles on, as the JAX build does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

from . import bvh8 as bvh8mod

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "bvh_builder.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")

_LIB: "ctypes.CDLL | None" = None


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep)))


def _load() -> ctypes.CDLL:
    """Compile (once per source hash) and dlopen the builder; raises if the
    source is missing or g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with open(SOURCE, "rb") as f:
        text = f.read()
    key = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()
                         + _cpu_id()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, key)
    lib_path = os.path.join(out_dir, "libbvh.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    fp, i32 = ctypes.POINTER(ctypes.c_float), ctypes.c_int32
    lib.build_bvh8.restype = ctypes.c_int
    lib.build_bvh8.argtypes = [fp, fp, fp, i32, fp, fp, i32,
                               ctypes.POINTER(ctypes.c_int32), i32]
    _LIB = lib
    return lib


def build_bvh8(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               n_threads: int = 8) -> bvh8mod.BVH8:
    """Native binned-SAH build with spatial splits and the 8-wide collapse."""
    T = v0.shape[0]
    lib = _load()
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    # spatial splits may duplicate references (budget 1.4x in the builder),
    # so leaf rows can exceed the triangle count
    max_rows = int(T * 1.5) + 16
    nodes = np.zeros((max_rows, 128), np.float32)
    leaves = np.zeros((max_rows, 128), np.float32)
    counts = np.zeros(2, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.build_bvh8(
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        T, nodes.ctypes.data_as(fp), leaves.ctypes.data_as(fp), max_rows,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if rc != 0:
        raise RuntimeError(f"native BVH build of {T} triangles failed ({rc})")
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    return bvh8mod.BVH8(nodes=nodes[:counts[0]].copy(),
                        leaves=leaves[:counts[1]].copy(),
                        world_lo=lo.astype(np.float32),
                        world_hi=hi.astype(np.float32))
