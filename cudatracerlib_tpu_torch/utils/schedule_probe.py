"""The designs that the shared variants of K1 and K2, K2's split
variant, and K3, were measured against.

``csrc/schedule_probe.cu`` holds them; on no render path. K1's and K2's
take the kept shared variant (the table in shared memory, one 512-thread
block per SM, stacks in local memory, rays from a per-warp queue) and
change one thing:

- ``"stride"``: rays by a static stride over the grid's threads instead
  of the queue;
- ``"smem_stack"``: each thread's ring stack in shared memory after the
  table.

``top_visits`` runs K2 in the two designs that its split variant (rows
0-452 in each SM's shared memory, the rest through L1/L2) was measured
against (``TOP_DESIGNS``): ``"cluster"``, the top table over the shared
memory of a cluster of `blocks` blocks (``slab_variant``'s by default; 2n
too), read through the cluster's windows, rays from the same queue in the
stream's work area; and ``"global"``, one thread per ray, rows through
L1/L2 (K2's first kernel).

``traverse8_group`` runs K1's global variant in the group design with 8
or 32 lanes a live ray, or with the kept 16 and an L2 prefetch of each
node step's eligible children (``GROUP_DESIGNS``), so that one call can
time them against the kept kernel.

``traverse_pool`` runs K4 with another threshold of idle lanes before a
warp claims rays (1, 8 or 16; K4 keeps one), or with another bound on a
lane's fetches in one iteration while it draws dead rays (1 or 2), or in
K4's first design: a
refill at every step, dead rays stepped, rows from device memory on every
table, a memset of the queue counter before each launch
(``POOL_DESIGNS``). ``pool_model`` is the plain model of K4's lane slots.

K3's stage each treelet slab on chip for the visits that share it, with
K3's per-slot code: a persistent grid of 512-thread blocks, one per SM,
walks chunks of the sorted slots and stages the slab of each treelet
segment of at least `min_stage` visits (``treelet_segments`` models the
split; the chunk size, the threshold and a stage-only switch are
arguments of ``treelet_hits``):

- ``"cluster"``: the slab spread over the shared memory of a cluster of
  ``slab_variant`` blocks (2 for 512-row slabs), read through the
  cluster's distributed shared memory;
- ``"split"``: one block, no cluster, holds rows 0-452 of the slab in its
  shared memory and reads the rest from device memory;
- ``"walk"``: the split design's schedule with nothing staged and no
  shared memory (the schedule's own cost).

``traverse8``, ``traverse_pool``, ``top_visits`` and ``treelet_hits``
take the arguments and return the outputs of
``ops.traversal8.intersect_wide_cuda``, ``intersect_wide_pool_cuda``,
``ops.traversal_tt.top_visits_cuda`` and ``treelet_hits_cuda``, bit for
bit alike; ``chip_smoke.py`` holds them to the plain versions and times
them beside the kept variants on the same rays. CUDA tensors only; the
library is built at first use.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import cuda_build, traversal8, traversal_tt
from ..ops.traversal import Rays
from ..scene.treelet import VID_ROOT_BITS

DESIGNS = {"stride": 0, "smem_stack": 1}
# K2's designs here: the shared variant's two (the table in shared memory)
# and the two measured against the split variant
TOP_DESIGNS = dict(DESIGNS, cluster=2, **{"global": 3})
# the group design of K1's global variant as measured against the kept
# one (16 lanes a live ray): 8 or 32 lanes, or 16 with an L2 prefetch of
# each node step's eligible children
GROUP_DESIGNS = {"g8": 0, "g32": 1, "g16p": 2}
# K4 at a threshold of 1, 8 or 16 idle lanes; at its own threshold with 1
# or 2 fetches an iteration; and its first design (the C entry's codes)
POOL_DESIGNS = {"first": 0, "f1": 1, "f8": 8, "f16": 16, "r1": 101, "r2": 102}
K3_DESIGNS = {"cluster": 0, "split": 1, "walk": 2}
CLUSTER_MAX = 8    # the largest cluster the cluster designs are built for
# the K3 designs' chunk of sorted slots and fewest visits of a staged
# segment, unless a call gives others (chip_smoke.py times a sweep)
CHUNK = 4096
MIN_STAGE = 256


def _lib():
    return cuda_build.load_library("schedule_probe.cu")


def _counter(dev, n=1):
    return torch.empty(n, dtype=torch.int32, device=dev)


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


def traverse8_group(table, rays: Rays, design: str, any_hit: bool = False,
                    stack_depth: int = traversal8.STACK_DEPTH,
                    max_iters: int = traversal8.MAX_ITERS, roots=None,
                    with_iters: bool = False, any_mask=None,
                    with_util: bool = False, _scratch=None):
    """K1's global variant in the group design `design` (``GROUP_DESIGNS``):
    the outputs of ``intersect_wide_cuda``, on the stream's work area
    (``traversal8.stream_group_work``) or on `_scratch`, a new one
    (``traversal8.group_work``)."""
    if design not in GROUP_DESIGNS:
        raise ValueError(f"no group design {design!r}: one of {list(GROUP_DESIGNS)}")
    args, out = traversal8._wide_args(table, rays, any_hit, stack_depth,
                                      max_iters, roots, any_mask)
    work, count_set = traversal8._work_area(rays.o.shape[0], table.device,
                                            True, _scratch)
    fn = _lib().ctl_probe_traverse8_group
    fn.argtypes = traversal8._WIDE_ARGTYPES + [ctypes.c_void_p] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, traversal8._ptr(work), count_set, GROUP_DESIGNS[design],
             traversal8._stream(table.device))
    return traversal8._wide_result(
        err, out, with_iters,
        traversal8._kernel_slots(work, count_set, with_util and with_iters),
        table.device if _scratch is None else None)


def traverse_pool(table, rays: Rays, design: str, any_hit: bool = False,
                  stack_depth: int = traversal8.STACK_DEPTH,
                  max_iters: int = traversal8.MAX_ITERS, roots=None,
                  with_iters: bool = False, any_mask=None,
                  with_util: bool = False, _scratch=None):
    """K4 in the design `design` (``POOL_DESIGNS``): the outputs of
    ``intersect_wide_pool_cuda``, rows from the variant the table's size
    picks (its first design: from device memory), on the stream's work area
    or on `_scratch`, a new one (``traversal8.group_work(0, dev)``)."""
    if design not in POOL_DESIGNS:
        raise ValueError(f"no K4 design {design!r}: one of {list(POOL_DESIGNS)}")
    args, out = traversal8._wide_args(table, rays, any_hit, stack_depth,
                                      max_iters, roots, any_mask)
    work, count_set = traversal8._work_area(rays.o.shape[0], table.device,
                                            False, _scratch)
    fn = _lib().ctl_probe_traverse_pool
    fn.argtypes = traversal8._WIDE_ARGTYPES + [ctypes.c_void_p] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, traversal8._ptr(work), count_set,
             traversal8.VARIANTS[traversal8.launch_variant(table)],
             POOL_DESIGNS[design], traversal8._stream(table.device))
    return traversal8._wide_result(
        err, out, with_iters,
        traversal8._kernel_slots(work, count_set, with_util and with_iters),
        table.device if _scratch is None else None)


def pool_model(steps, dead, warps: int, fetch_idle: int, rounds: int = 4,
               skip_dead: bool = True):
    """Plain model of K4's lane slots (csrc/traversal_pool.cu) from each
    ray's steps and dead flag (numpy arrays in queue order): `warps`
    resident warps of 32 lanes step in lock step and claim rays from one
    queue in warp order; a warp with at least `fetch_idle` idle lanes
    claims one ray an idle lane, up to `rounds` times while it draws dead
    rays (with `skip_dead`; each such round is 32 slots whose dead rays run
    their one step), and each iteration that steps a lane is 32 slots.
    The card's order of claims differs; the model says what the queue and
    the threshold can recover on a batch. Returns (slots, lane steps)."""
    steps = np.asarray(steps, np.int64)
    dead = np.asarray(dead, bool) & skip_dead
    n = len(steps)
    rem = np.zeros((warps, 32), np.int64)
    done = np.zeros(warps, bool)
    q = slots = active = 0
    while not done.all():
        for w in np.flatnonzero(~done):
            r = rem[w]
            idle = np.flatnonzero(r == 0)
            if q < n and len(idle) >= fetch_idle:
                for _ in range(rounds):
                    k = min(len(idle), n - q)
                    ids = np.arange(q, q + k)
                    q += k
                    live = ids[~dead[ids]]
                    r[idle[:len(live)]] = steps[live]
                    idle = idle[len(live):]
                    if k == len(live):
                        break
                    slots += 32
                    active += k - len(live)
            run = r > 0
            if not run.any():
                done[w] = q >= n
                continue
            slots += 32
            active += int(run.sum())
            r[run] -= 1
    return slots, active


def top_visits(top, rays: Rays, V: int, design: str, blocks: int = None,
               any_hit: bool = False, any_mask=None, roots=None):
    """K2 in `design` (``TOP_DESIGNS``: the shared variant's "stride" and
    "smem_stack", which need the table in one block's shared memory; the
    "cluster" design over `blocks` blocks, 1, 2, 4 or 8, ``slab_variant``'s
    for the table by default; "global", one thread per ray): the outputs
    of ``top_visits_cuda``."""
    if design not in TOP_DESIGNS:
        raise ValueError(f"no K2 design {design!r}: one of {list(TOP_DESIGNS)}")
    if blocks is not None and (design != "cluster" or blocks not in (1, 2, 4, 8)):
        raise ValueError(f"the cluster design takes 1, 2, 4 or 8 blocks, not "
                         f"{blocks} ({design})")
    traversal8._check_table(top, "top")   # before the build
    if design == "cluster":
        blocks = blocks or slab_variant(top.shape[0],
                                        traversal8._shared_limit(top.device.index))
        if not blocks:
            raise ValueError(f"no cluster of up to {CLUSTER_MAX} blocks holds "
                             f"{top.shape[0]} rows")
        scratch, count_set = traversal8.stream_group_work(rays.o.shape[0],
                                                          top.device, queue=False)
    elif design == "global":
        scratch, count_set = None, 0
    else:
        scratch, count_set = _counter(top.device), 0
    ci = ctypes.c_int
    return traversal_tt.launch_top(
        _lib().ctl_probe_top_visits, TOP_DESIGNS[design], scratch,
        top, rays, V, any_hit, any_mask, traversal8.STACK_DEPTH,
        traversal8.MAX_ITERS, roots, [(ci, blocks or 0), (ci, count_set)],
        stream_work=design == "cluster")


def slab_variant(rows: int, shared_limit: int,
                 cluster_max: int = CLUSTER_MAX) -> int:
    """The blocks of a cluster design's cluster for a table or slab of
    `rows` fat rows on a card whose blocks may opt in to `shared_limit`
    bytes of shared memory: the fewest, a power of two up to
    `cluster_max`, whose shares (ceil(rows / n) rows of ROW_BYTES each, the
    designs' only dynamic shared memory) fit; 0 when none does. On an H100
    (454 rows a block): 2 for 512-row slabs, 4 for 1,024."""
    n = 1
    while n <= cluster_max:
        if -(-rows // n) * traversal8.ROW_BYTES <= shared_limit:
            return n
        n *= 2
    return 0


def treelet_segments(keys, n_treelets: int, chunk: int, min_stage: int):
    """Plain model of how the K3 designs split the sorted slots: chunks of
    `chunk` slots, each cut into segments, the runs of one treelet id
    within the chunk. Returns (start, end, tid, staged) over the valid
    segments in slot order, each (n_segments,): int64 bounds, the treelet
    id, and whether a design stages the segment's slab (at least
    `min_stage` visits). Invalid slots (treelet id n_treelets, sorted last)
    fall in no segment."""
    S, dev = keys.shape[0], keys.device
    tid = (keys >> VID_ROOT_BITS).long()
    pos = torch.arange(S, device=dev)
    first = pos % chunk == 0
    first[1:] |= tid[1:] != tid[:-1]
    start = pos[first]
    end = torch.cat([start[1:], torch.full((1,), S, device=dev)])
    seg_tid = tid[start]
    valid = seg_tid < n_treelets
    start, end, seg_tid = start[valid], end[valid], seg_tid[valid]
    return start, end, seg_tid, end - start >= min_stage


def treelet_hits(slabs, rays: Rays, t_prune, keys, order, V: int,
                 design: str, chunk: int = CHUNK, min_stage: int = MIN_STAGE,
                 stage_only: bool = False, any_hit: bool = False,
                 any_mask=None, _scratch=None):
    """K3 in `design` (``K3_DESIGNS``) on chunks of `chunk` sorted slots,
    staging the segments of at least `min_stage` visits: the outputs of
    ``ops.traversal_tt.treelet_hits_cuda``, bit for bit. Its int32[2]
    scratch, allocated here or given as `_scratch`, holds after the launch
    the chunk queue's counter and the number of segments it staged
    (``treelet_segments``). With `stage_only` it stages and walks but
    traverses nothing, and its outputs are not written. Raises on CPU
    tensors, an unknown design, and a slab no cluster holds."""
    if design not in K3_DESIGNS:
        raise ValueError(f"no K3 design {design!r}: one of {list(K3_DESIGNS)}")
    traversal_tt._check_k3(V, any_hit, traversal8.STACK_DEPTH, any_mask)
    traversal8._check_table(slabs, "slabs", 2)   # before the build
    dev = slabs.device
    ranks = 1
    if design == "cluster":
        ranks = slab_variant(slabs.shape[1], traversal8._shared_limit(dev.index))
        if not ranks:
            raise ValueError(f"no cluster of up to {CLUSTER_MAX} blocks holds "
                             f"a slab of {slabs.shape[1]} rows")
    scratch = _counter(dev, 2) if _scratch is None else _scratch
    traversal8._require(scratch, "_scratch", torch.int32, (2,), dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return traversal_tt.launch_treelet(
        _lib().ctl_probe_treelet_hits,
        [(vp, traversal8._ptr(scratch)), (ci, K3_DESIGNS[design]), (ci, ranks),
         (ci, chunk), (ci, min_stage), (ci, int(stage_only))],
        slabs, rays, t_prune, keys, order, V, any_hit, any_mask,
        traversal8.STACK_DEPTH, traversal8.MAX_ITERS)
