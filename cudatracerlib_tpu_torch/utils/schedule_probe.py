"""The designs that the shared variants of K1 and K2 were measured against.

``csrc/schedule_probe.cu`` holds them; on no render path. Each takes the
kept shared variant (the table in shared memory, one 512-thread block per
SM, stacks in local memory, rays from a per-warp queue) and changes one
thing:

- ``"stride"``: rays by a static stride over the grid's threads instead
  of the queue;
- ``"smem_stack"``: each thread's ring stack in shared memory after the
  table.

``traverse8`` and ``top_visits`` take the arguments and return the outputs
of ``ops.traversal8.intersect_wide_cuda`` and
``ops.traversal_tt.top_visits_cuda``, bit for bit alike; ``chip_smoke.py``
holds them to the plain versions and times them beside the kept variants
on the same rays. CUDA tensors only; the library is built at first use.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build, traversal8, traversal_tt
from ..ops.traversal import Rays

DESIGNS = {"stride": 0, "smem_stack": 1}


def _lib():
    return cuda_build.load_library("schedule_probe.cu")


def _counter(dev):
    return torch.empty(1, dtype=torch.int32, device=dev)


def traverse8(table, rays: Rays, design: str, any_hit: bool = False,
              with_iters: bool = False, any_mask=None):
    """K1's shared variant in `design` (``DESIGNS``): the outputs of
    ``intersect_wide_cuda``."""
    args, out = traversal8._wide_args(table, rays, any_hit,
                                      traversal8.STACK_DEPTH,
                                      traversal8.MAX_ITERS, None, any_mask)
    fn = _lib().ctl_probe_traverse8
    fn.argtypes = traversal8._WIDE_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, traversal8._ptr(_counter(table.device)), DESIGNS[design],
             traversal8._stream(table.device))
    return traversal8._wide_result(err, out, with_iters)


def top_visits(top, rays: Rays, V: int, design: str, any_hit: bool = False,
               any_mask=None):
    """K2's shared variant in `design`: the outputs of ``top_visits_cuda``."""
    traversal8._check_table(top, "top")   # before the build
    return traversal_tt.launch_top(
        _lib().ctl_probe_top_visits, DESIGNS[design], _counter(top.device),
        top, rays, V, any_hit, any_mask, traversal8.STACK_DEPTH,
        traversal8.MAX_ITERS)
