"""Wide (8-ary) BVH traversal over the fat-row table.

Port of ``cudatracerlib_tpu/ops/traversal8.py``. Three implementations of
one traversal, with the same per-ray semantics, step counts and flags:

- ``intersect_wide_cuda``: the wrapper of the hand-written Hopper kernel K1,
  ``csrc/traversal8.cu``, which replaces the TPU kernel
  ``cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel``. It takes CUDA
  tensors only. A table that fits a block's shared memory
  (``table_variant``) runs the shared variant: one block per SM holds the
  table; a larger one runs the global variant, rows from device memory,
  one thread per ray, or in the group design where the caller asks for it
  (the flat treelet fallback: dead lanes written without a row read, live
  rays drained from a queue by groups of lanes; ``live_lanes`` models the
  queue).
- ``intersect_wide_pool_cuda``: the wrapper of K4, ``csrc/traversal_pool.cu``,
  which replaces the TPU kernel ``traversal_pl.py::_traverse_kernel_pool``:
  persistent warps whose lanes take the next ray of a global queue when
  enough of them are idle, dead lanes written at fetch, rows from shared
  memory where the table fits (``launch_variant``). It computes exactly
  K1's function and only schedules rays differently, so its plain version
  is ``intersect_wide`` itself. CUDA tensors only.
- ``intersect_wide``: the plain PyTorch version of both, a lockstep batch
  loop like the JAX ``intersect_wide`` (``_lockstep``, shared with the
  plain versions of K2 and K3). It serves CPU tensors, and the tests and
  ``chip_smoke.py`` hold the kernels against it.

``intersect_scene`` sends an instanced scene to the two-level traversal
(``ops/instanced.py``), whose BLAS visits come back here with per-lane
roots; a table with treelet tables to the two-phase treelet traversal
(``ops/traversal_tt.py``) with K1 as its exactness fallback; and any other
table by its device to K1 or to the plain version. K4 is called only
through ``intersect_wide_pool``.

Per ray: a stack entry is (row << 8) | unvisited-child mask; the stack is a
ring of ``stack_depth`` entries that drops its oldest entry when a push
finds it full (flag bit 1); a ray still running after ``max_iters`` steps
keeps its best hit so far (flag bit 0). One step fetches one 512-byte row,
so a ray's step count is also its count of rows read. These are per-ray
counts, not the TPU kernel's lockstep iterations.

``with_util`` (with ``with_iters``) adds the lane-utilization count of the
JAX kernels: ``slots``, an int64 scalar, the lane slots the launch issued
(32 for each warp iteration of its traversal loop); the utilization is
``steps.sum() / slots``, the JAX ``act_sum / rows`` (its ``act_sum`` counts
the active lane steps, which ``steps`` sums). K1's shared variant and its
per-thread design run each warp on 32 consecutive rays to the end of the
slowest, so their slots are ``static_slots(steps)``, and so are the plain
version's; K4 and K1's group design hand rays out inside the launch, and
their kernels count the slots and the lane steps (which equal
``steps.sum()``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import timers
from . import cuda_build
from .traversal import Hit, Rays, _safe_inv

Tensor = torch.Tensor

DONE = -1
POP = -0x40000000
STACK_DEPTH = 24
MAX_ITERS = 4096
FLAG_CAPPED = 1
FLAG_OVERFLOW = 2
_INF = float("inf")
ROW_BYTES = 512
# threads of a shared-variant block of K1 or K2, one block per SM
# (kPersistThreads in csrc/bvh8_traverse.cuh)
SHARED_THREADS = 512
# the launch variants of K1 and K4, by their C entries' codes
VARIANTS = {"global": 0, "shared": 1}
# the designs of K1's global variant: "thread", one thread per ray; "group",
# dead lanes written without a row read and live rays drained from a queue
# by groups of 16 lanes (csrc/traversal8.cu); the C entry's codes
# for the group design counting in set 0 or 1 of its work area
GLOBAL_DESIGNS = ("thread", "group")
GROUP_CODE = 2
# the work area of the launches that hand out rays inside the launch (K1's
# group design, K4; csrc/warp_queue.cuh): GROUP_WORK int32 words of two
# counter sets (a launch counts in one, zero, and zeroes the other), then,
# for the group design, one queue slot per ray. Set 0's counters: at
# GROUP_COUNTERS, int32, the rays claimed, the live rays, the group
# design's queue claims, the rays classified (written dead or taken live);
# at UTIL_COUNTERS, int64 over two words each, the lane slots issued and
# the lane steps run in them
GROUP_WORK = 384
GROUP_COUNTERS = (0, 32, 64, 96)
UTIL_COUNTERS = (128, 160)
# the design K1's global variant takes on the flat treelet path's fallback
# batch, whose lanes are dead but for the few whose visits overflowed (tens
# to thousands of a batch). The instanced visits' fallback (per-lane roots)
# keeps one thread per ray: its batches hold 0-3 live lanes, where the group
# design's fixed cost (~3 us a launch on an H100) is not repaid (PERF.md)
FALLBACK_DESIGN = "group"
# float32 operations of a node step, counted from csrc/bvh8_traverse.cuh:
# 26 per child (6 subtractions and 6 products for the slab distances, 12
# min/max, 2 compares) for 8 children. A leaf step does more (about 54 per
# triangle for 12 triangles), so steps times this is a lower bound.
NODE_STEP_FLOPS = 26 * 8
# bytes of its row a step must read: a node step the 8 children's boxes and
# links (words 0-55), a leaf step the 12 triangles and their ids (0-119)
NODE_STEP_BYTES, LEAF_STEP_BYTES = 56 * 4, 120 * 4
# optional callable(table, rows, is_node, is_leaf): while set, the plain
# versions report each step's row fetch to it (chip_smoke.py counts the
# distinct rows a call reads for its bound)
on_fetch = None


def pack_unified(bvh8_nodes, bvh8_leaves):
    """Concatenate node+leaf rows into one table, remapping leaf links."""
    n8 = bvh8_nodes.shape[0]
    nodes = bvh8_nodes.copy()
    links = nodes[:, 48:56].view(np.int32)
    leaf = links <= -2
    links[leaf] = -2 - (n8 + (-2 - links[leaf]))
    return np.concatenate([nodes, bvh8_leaves], axis=0)


def _check_args(any_hit, stack_depth, any_mask):
    if any_hit and any_mask is not None:
        raise ValueError("any_hit and any_mask are exclusive")
    if not 1 <= stack_depth <= 64:   # kMaxStack in csrc/traversal8.cu
        raise ValueError(f"stack_depth {stack_depth} outside [1, 64]")


def _lockstep(table: Tensor, rays: Rays, cur: Tensor, t_best: Tensor,
              anyh: Tensor, stack_depth: int, max_iters: int,
              base: Tensor = None, n_rows: int = None, n_real: int = None,
              V: int = 0):
    """The plain versions' lockstep loop: one traversal per lane, all lanes
    stepped together until each is DONE or capped. The three kernels' plain
    versions share it (K1: ``intersect_wide``; K2 and K3 in
    ``ops/traversal_tt.py``), as the kernels share ``csrc/bvh8_traverse.cuh``.

    cur: (B,) int32 start state ((root << 8) | 0xFF, or DONE for a lane that
    does not run); t_best: (B,) initial best t (the ray's tmax); anyh: (B,)
    bool per-lane any-hit. base: optional (B,) per-lane row offset into
    `table` (a treelet slab), whose rows are clamped to [0, n_rows).
    n_real: leaves at or beyond this row are VIRTUAL (K2): the lane records
    a visit (row - n_real) with the entry t of the descend that reached it,
    keeping its V nearest, instead of testing triangles.

    Returns (hit, steps, flags, visits); visits is None, or with V > 0
    (vids (B, V) i32, -1 unused; entry ts (B, V); visit count (B,) i32;
    smallest entry t among the dropped visits (B,), inf if none)."""
    dev = table.device
    B = rays.o.shape[0]
    n_rows = table.shape[0] if n_rows is None else n_rows
    inv_d = _safe_inv(rays.d)
    ox, oy, oz = (rays.o[:, k:k + 1] for k in range(3))     # (B, 1)
    ix, iy, iz = (inv_d[:, k:k + 1] for k in range(3))
    dx, dy, dz = (rays.d[:, k:k + 1] for k in range(3))
    tmn = rays.tmin[:, None]
    bit8 = (1 << torch.arange(8, dtype=torch.int32, device=dev))[None, :]
    lanes = torch.arange(B, device=dev)

    t_best = t_best.clone()
    tri_best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(B, dtype=torch.float32, device=dev)
    v_best = torch.zeros(B, dtype=torch.float32, device=dev)
    stack = torch.zeros((B, stack_depth), dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    flags = torch.zeros(B, dtype=torch.uint8, device=dev)
    if V:
        vids = torch.full((B, V), -1, dtype=torch.int32, device=dev)
        vent = torch.zeros((B, V), dtype=torch.float32, device=dev)
        vcnt = torch.zeros(B, dtype=torch.int32, device=dev)
        mdrop = torch.full((B,), _INF, dtype=torch.float32, device=dev)
        tent = torch.zeros(B, dtype=torch.float32, device=dev)

    while True:
        active = (cur != DONE) & (steps < max_iters)
        if not bool(active.any()):
            break
        steps += active.to(torch.int32)
        is_node = active & (cur >= 0)
        is_leaf = active & (cur <= -2)
        row_raw = torch.where(cur >= 0, cur >> 8, -2 - cur)
        if n_real is not None:
            virtual = is_leaf & (row_raw >= n_real)
            is_leaf = is_leaf & ~virtual
        row_idx = row_raw.clamp(0, n_rows - 1)
        if base is not None:
            row_idx = row_idx + base
        row = table[row_idx.long()]                                  # (B, 128)
        if on_fetch is not None:
            on_fetch(table, row_idx, is_node, is_leaf)
        tb = t_best[:, None]

        # node step: slab-test all 8 children, pick the nearest (lowest j on ties)
        t0x = (row[:, 0:8] - ox) * ix
        t1x = (row[:, 24:32] - ox) * ix
        t0y = (row[:, 8:16] - oy) * iy
        t1y = (row[:, 32:40] - oy) * iy
        t0z = (row[:, 16:24] - oz) * iz
        t1z = (row[:, 40:48] - oz) * iz
        tn = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.maximum(torch.minimum(t0z, t1z), tmn))
        tf = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), tb))
        links = row[:, 48:56].view(torch.int32)
        eligible = (tn <= tf) & (links != DONE) & (((cur & 0xFF)[:, None] & bit8) != 0)
        t_sel = torch.where(eligible, tn, _INF)
        best_t = torch.full((B,), _INF, dtype=torch.float32, device=dev)
        best_j = torch.zeros(B, dtype=torch.int32, device=dev)
        for j in range(8):
            closer = t_sel[:, j] < best_t
            best_t = torch.where(closer, t_sel[:, j], best_t)
            best_j = torch.where(closer, j, best_j)
        has_child = best_t < _INF
        link_best = links[lanes, best_j.long()]
        elig_bits = (eligible.to(torch.int32) * bit8).sum(1, dtype=torch.int32)
        remaining = elig_bits & ~(1 << best_j)
        descend = torch.where(link_best >= 0, (link_best << 8) | 0xFF, link_best)
        node_next = torch.where(has_child, descend, POP)
        push = is_node & has_child & (remaining != 0)
        push_val = ((cur >> 8) << 8) | remaining

        # leaf step: Moller-Trumbore on 12 triangles (lowest slot on ties)
        v0x, v0y, v0z = row[:, 0:12], row[:, 12:24], row[:, 24:36]
        e1x, e1y, e1z = row[:, 36:48], row[:, 48:60], row[:, 60:72]
        e2x, e2y, e2z = row[:, 72:84], row[:, 84:96], row[:, 96:108]
        ids = row[:, 108:120].view(torch.int32)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        tri_ok = ((ids != -1) & (det.abs() >= 1e-12) & (u >= 0) & (v >= 0)
                  & (u + v <= 1.0) & (t > tmn) & (t < tb))
        t_tri = torch.where(tri_ok, t, _INF)
        t_hit = torch.full((B,), _INF, dtype=torch.float32, device=dev)
        k_hit = torch.zeros(B, dtype=torch.int64, device=dev)
        for k in range(12):
            closer = t_tri[:, k] < t_hit
            t_hit = torch.where(closer, t_tri[:, k], t_hit)
            k_hit = torch.where(closer, k, k_hit)
        leaf_hit = is_leaf & (t_hit < _INF)
        t_best = torch.where(leaf_hit, t_hit, t_best)
        tri_best = torch.where(leaf_hit, ids[lanes, k_hit], tri_best)
        u_best = torch.where(leaf_hit, u[lanes, k_hit], u_best)
        v_best = torch.where(leaf_hit, v[lanes, k_hit], v_best)

        if V:
            # virtual leaf: keep the V nearest visits by entry t; once full, a
            # closer visit replaces the farthest kept one (lowest slot among
            # equal maxima), and the smallest dropped entry t is tracked
            full = vcnt >= V
            t_far = vent[:, 0].clone()   # vent is written below
            j_far = torch.zeros(B, dtype=torch.int64, device=dev)
            for k in range(1, V):
                farther = vent[:, k] > t_far
                t_far = torch.where(farther, vent[:, k], t_far)
                j_far = torch.where(farther, k, j_far)
            replace = virtual & full & (tent < t_far)
            write = (virtual & ~full) | replace
            slot = torch.where(full, j_far, vcnt.clamp_max(V - 1).long())
            vids[lanes, slot] = torch.where(write, row_raw - n_real, vids[lanes, slot])
            vent[lanes, slot] = torch.where(write, tent, vent[lanes, slot])
            dropped = torch.where(replace, t_far, tent)
            mdrop = torch.where(virtual & full, torch.minimum(mdrop, dropped), mdrop)
            vcnt = vcnt + virtual.to(torch.int32)
            # the entry t of the child descended into: a leaf is only ever
            # reached by a descend, so this is its slab-entry t
            tent = torch.where(is_node & has_child, best_t, tent)

        # combine, push, pop (ring stack: a full stack drops its oldest entry)
        nxt = torch.where(is_node, node_next, POP)
        nxt = torch.where(leaf_hit & anyh, DONE, nxt)
        pos = torch.where(push, (pos + 1) % stack_depth, pos)
        stack[lanes, pos] = torch.where(push, push_val, stack[lanes, pos])
        flags |= (push & (n == stack_depth)).to(torch.uint8) * FLAG_OVERFLOW
        n = torch.where(push, (n + 1).clamp_max(stack_depth), n)
        can_pop = active & (nxt == POP) & (n > 0)
        popped = stack[lanes, pos]
        pos = torch.where(can_pop, (pos - 1) % stack_depth, pos)
        n = torch.where(can_pop, n - 1, n)
        nxt = torch.where(nxt == POP, torch.where(can_pop, popped, DONE), nxt)
        cur = torch.where(active, nxt, cur)

    flags |= (cur != DONE).to(torch.uint8) * FLAG_CAPPED
    hit = Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)
    return hit, steps, flags, ((vids, vent, vcnt, mdrop) if V else None)


def any_lanes(B: int, any_hit: bool, any_mask: Tensor, device) -> Tensor:
    """(B,) bool per-lane any-hit flags from the two ways of asking."""
    if any_hit:
        return torch.ones(B, dtype=torch.bool, device=device)
    if any_mask is not None:
        return any_mask.to(torch.bool)
    return torch.zeros(B, dtype=torch.bool, device=device)


def static_slots(steps: Tensor) -> Tensor:
    """The lane slots of K1's static schedule, int64: each warp runs 32
    consecutive rays (the last group padded) to the end of its slowest, so
    32 times the sum over 32-ray groups of the largest of `steps`."""
    s = torch.nn.functional.pad(steps, (0, -steps.shape[0] % 32))
    return s.view(-1, 32).amax(1).sum(dtype=torch.int64) * 32


def intersect_wide(table: Tensor, rays: Rays, any_hit: bool = False,
                   stack_depth: int = STACK_DEPTH,
                   max_iters: int = MAX_ITERS, roots: Tensor = None,
                   with_iters: bool = False, any_mask: Tensor = None,
                   with_util: bool = False):
    """Plain PyTorch traversal of the (R, 128) fat-row table.

    any_mask: optional (B,) bool giving per-lane any-hit semantics (lanes
    True stop at their first leaf hit), so one call traces a mixed
    closest+shadow wavefront. Returns a Hit, or with with_iters
    (hit, steps (B,) int32, flags (B,) uint8), and with with_util too the
    slots of K1's static schedule (``static_slots``)."""
    _check_args(any_hit, stack_depth, any_mask)
    if table.is_cuda:
        intersect_wide.cuda_calls += 1
    dev = table.device
    B = rays.o.shape[0]
    if roots is None:
        roots = torch.zeros(B, dtype=torch.int32, device=dev)
    cur = (roots.to(torch.int32) << 8) | 0xFF
    hit, steps, flags, _ = _lockstep(
        table, rays, cur, rays.tmax, any_lanes(B, any_hit, any_mask, dev),
        stack_depth, max_iters)
    if with_iters and with_util:
        return hit, steps, flags, static_slots(steps)
    if with_iters:
        return hit, steps, flags
    return hit


intersect_wide.cuda_calls = 0   # calls that got CUDA tensors (comparisons only)


def _ptr(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _require(x: Tensor, name: str, dtype, shape, device):
    if not isinstance(x, Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the table on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(table: Tensor, name: str, width_dims: int = 1):
    """A CUDA float32 (..., 128) table, non-empty and 16-byte aligned (the
    kernels read it as float4)."""
    if not (isinstance(table, Tensor) and table.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    _require(table, name, torch.float32,
             tuple(table.shape[:width_dims]) + (128,), table.device)
    if table.numel() == 0 or table.data_ptr() % 16:
        raise ValueError(f"{name} must be non-empty and 16-byte aligned")


def _check_rays(rays: Rays, dev, with_tmax: bool = True) -> int:
    B = rays.o.shape[0]
    _require(rays.o, "rays.o", torch.float32, (B, 3), dev)
    _require(rays.d, "rays.d", torch.float32, (B, 3), dev)
    _require(rays.tmin, "rays.tmin", torch.float32, (B,), dev)
    if with_tmax:
        _require(rays.tmax, "rays.tmax", torch.float32, (B,), dev)
    return B


def _mask_u8(any_mask: Tensor, B: int, dev):
    if any_mask is None:
        return None
    _require(any_mask, "any_mask", torch.bool, (B,), dev)
    return any_mask.view(torch.uint8)


def table_variant(rows: int, shared_limit: int) -> str:
    """The variant of K1 or K4 for a table of `rows` fat rows on a card whose
    blocks may opt in to `shared_limit` bytes of shared memory: "shared"
    when the table fits (rows x ROW_BYTES bytes, the shared variant's only
    shared memory), else "global"."""
    return "shared" if rows * ROW_BYTES <= shared_limit else "global"


@functools.lru_cache(maxsize=None)
def _shared_limit(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def launch_variant(table: Tensor, forced: str = None) -> str:
    """The variant a K1 or K4 launch on `table` ((R, 128), CUDA) takes:
    ``table_variant`` of its rows and its card's opt-in shared-memory limit,
    or `forced` (a test hook: chip_smoke.py and the gpu tests run every
    variant on the same rays)."""
    if forced is not None:
        if forced not in VARIANTS:
            raise ValueError(f"no K1/K2 variant {forced!r}: one of {list(VARIANTS)}")
        return forced
    return table_variant(table.shape[0], _shared_limit(table.device.index))


def live_lanes(rays: Rays, max_iters: int = MAX_ITERS,
               roots: Tensor = None) -> Tensor:
    """(B,) bool: the lanes the group design traverses; it writes every
    other lane's outputs without reading the table. A lane with
    !(tmin <= tmax) (a NaN included) that starts on a node row takes one
    step in ``intersect_wide``: the root admits no child (tn >= tmin > tmax
    >= tf, or a NaN fails tn <= tf) and the stack is empty, so its outputs
    are t = tmax, tri -1, u = v = 0, one step and no flag whatever the
    table, for max_iters >= 1. A lane with tmin = tmax is live: it may
    descend boxes that hold its origin."""
    B = rays.o.shape[0]
    start = torch.zeros(B, dtype=torch.int32, device=rays.o.device) \
        if roots is None else (roots.to(torch.int32) << 8) | 0xFF
    return (rays.tmin <= rays.tmax) | (start < 0) | (max_iters < 1)


def _check_design(design):
    if design is not None and design not in GLOBAL_DESIGNS:
        raise ValueError(f"no design {design!r} of K1's global variant: one "
                         f"of {list(GLOBAL_DESIGNS)}")


def group_work(B: int, dev) -> Tensor:
    """A new work area with B queue slots (the group design's for B rays;
    K4 takes B = 0), its counters zero."""
    return torch.zeros(GROUP_WORK + B, dtype=torch.int32, device=dev)


def work_util(work: Tensor, count_set: int = 0) -> Tensor:
    """(2,) int64 view of a work area's counter set `count_set`: the lane
    slots its launch issued and the lane steps run in them."""
    base = count_set * GROUP_WORK // 2
    return torch.stack([work[base + w:base + w + 2].view(torch.int64)[0]
                        for w in UTIL_COUNTERS])


# the work area of each (device, stream) and the counter set its next
# launch takes: launches on a stream (the group design's and K4's) take the
# sets in turn, each zeroing the other's, so no launch needs a memset; a
# new area (zeros, set 0), at the next power of two of queue slots, when a
# batch outgrows it
_group_work = {}


def stream_group_work(B: int, dev, queue: bool = True):
    """(work area, counter set) for the next launch of B rays on `dev`'s
    current stream: the group design's (`queue`: B queue slots) or K4's
    (no slots). No rays launch nothing and take no set."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    work, count_set = _group_work.get(key, (None, 0))
    slots = B if queue else 0
    if work is None or work.numel() < GROUP_WORK + slots:
        work, count_set = group_work(1 << max(slots - 1, 1).bit_length(), dev), 0
    _group_work[key] = (work, 1 - count_set if B > 0 else count_set)
    return work, count_set


def forget_stream_work(dev):
    """Drop the work area of `dev`'s current stream after a launch on it
    that the card refused. That launch zeroed no counter set, so the set
    the next launch would take may hold an older launch's counts, and a
    launch that starts on counts skips rays or waits for rays no launch
    classifies. The next launch takes a new area."""
    _group_work.pop((dev.index, torch.cuda.current_stream(dev).cuda_stream), None)


def queue_counter(variant: str, dev):
    """The ray queue counter a K1 launch of `variant`, or K2's shared
    variant, needs: an int32 scratch tensor for the shared variant (its C
    entry zeroes it on the stream), None for the global one."""
    if variant == "global":
        return None
    return torch.empty(1, dtype=torch.int32, device=dev)


_WIDE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


def _wide_args(table: Tensor, rays: Rays, any_hit, stack_depth, max_iters,
               roots, any_mask):
    """Check the arguments that K1 and K4 share and allocate their outputs:
    (the C entry's leading arguments, (t, tri, u, v, steps, flags))."""
    _check_args(any_hit, stack_depth, any_mask)
    _check_table(table, "table")
    dev = table.device
    B = _check_rays(rays, dev)
    if roots is not None:
        _require(roots, "roots", torch.int32, (B,), dev)
    mask_u8 = _mask_u8(any_mask, B, dev)
    out = tuple(torch.empty(B, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32, torch.int32,
        torch.uint8))
    args = [_ptr(table), table.shape[0], _ptr(rays.o), _ptr(rays.d),
            _ptr(rays.tmin), _ptr(rays.tmax), _ptr(roots), _ptr(mask_u8), B,
            int(bool(any_hit)), stack_depth, max_iters, *(_ptr(x) for x in out)]
    return args, out


def _wide_result(err: int, out, with_iters: bool, slots: Tensor = None,
                 stream_dev=None):
    """The outputs of a K1 or K4 launch: the hit, with `with_iters` its
    steps and flags, and `slots` when given and with_iters. stream_dev: the
    device whose stream's work area the launch took (None: it took none),
    dropped if the launch failed (``forget_stream_work``)."""
    if err != 0:
        if stream_dev is not None:
            forget_stream_work(stream_dev)
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    t, tri, u, v, steps, flags = out
    hit = Hit(t=t, tri=tri, u=u, v=v)
    if with_iters and slots is not None:
        return hit, steps, flags, slots
    if with_iters:
        return hit, steps, flags
    return hit


def _work_area(B: int, dev, queue: bool, scratch: Tensor = None):
    """(work area, counter set) of a group-design or K4 launch: the
    stream's (``stream_group_work``), or `scratch`, a new one
    (``group_work``: B queue slots with `queue`, none without), counting in
    set 0."""
    if scratch is None:
        return stream_group_work(B, dev, queue)
    _require(scratch, "_scratch", torch.int32,
             (GROUP_WORK + (B if queue else 0),), dev)
    return scratch, 0


def _kernel_slots(work: Tensor, count_set: int, wanted: bool):
    """The slots counter of a launch counting in `count_set` of `work`,
    copied out before a later launch on the stream zeroes it, when
    `wanted` (with_util and with_iters), else None."""
    return work_util(work, count_set)[0] if wanted else None


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def intersect_wide_cuda(table: Tensor, rays: Rays, any_hit: bool = False,
                        stack_depth: int = STACK_DEPTH,
                        max_iters: int = MAX_ITERS, roots: Tensor = None,
                        with_iters: bool = False, any_mask: Tensor = None,
                        with_util: bool = False, _variant: str = None,
                        _design: str = None, _scratch: Tensor = None):
    """Launch K1 (``csrc/traversal8.cu``) on the current stream: the same
    signature, results, step counts and flags as ``intersect_wide``. With
    `with_util` (and with_iters) the slots come from the steps
    (``static_slots``: the shared variant and the per-thread design run 32
    consecutive rays a warp), or from the group design's own count.

    Takes CUDA tensors only: (R, 128) float32 table; rays o, d (B, 3) and
    tmin, tmax (B,) float32; roots (B,) int32; any_mask (B,) bool. Raises on
    anything else, and when the card refuses the launch. The variant comes
    from the table's size (``launch_variant``; `_variant` forces one). The
    global variant runs in `_design` (``GLOBAL_DESIGNS``): "thread" unless
    the caller asks for "group", as the flat treelet fallback does
    (``FALLBACK_DESIGN``). The shared variant's ray queue counter is an
    int32 scratch tensor allocated here (``queue_counter``); the group
    design's work area is kept for the stream (``stream_group_work``), or
    `_scratch` gives it a new one (``group_work``), whose
    ``GROUP_COUNTERS`` then read. Each launch adds one to
    ``intersect_wide_cuda.launches``, to
    ``intersect_wide_cuda.launches_by_variant[variant]``, to
    ``intersect_wide_cuda.launches_by_mode[mode]`` (``launch_mode``) and, on
    the global variant, to ``intersect_wide_cuda.launches_by_design``."""
    _check_design(_design)
    args, out = _wide_args(table, rays, any_hit, stack_depth, max_iters, roots,
                           any_mask)
    variant = launch_variant(table, _variant)
    design = (_design or "thread") if variant == "global" else None
    code = VARIANTS[variant]
    if design == "group":
        counter, count_set = _work_area(rays.o.shape[0], table.device, True,
                                        _scratch)
        code = GROUP_CODE + count_set
    else:
        counter = queue_counter(variant, table.device)
    fn = cuda_build.load_library("traversal8.cu").ctl_traverse8
    fn.argtypes = _WIDE_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, _ptr(counter), code, _stream(table.device))
    wanted = with_util and with_iters
    slots = (_kernel_slots(counter, count_set, wanted) if design == "group"
             else static_slots(out[4]) if wanted else None)
    res = _wide_result(err, out, with_iters, slots,
                       table.device if design == "group" and _scratch is None
                       else None)
    intersect_wide_cuda.launches += 1
    intersect_wide_cuda.launches_by_variant[variant] += 1
    intersect_wide_cuda.launches_by_mode[launch_mode(any_hit, any_mask)] += 1
    if design is not None:
        intersect_wide_cuda.launches_by_design[design] += 1
    return res


MODES = ("closest", "any_hit", "mixed")


def launch_mode(any_hit: bool, any_mask: Tensor = None) -> str:
    """A traversal's mode: "any_hit" (every lane), "mixed" (per-lane
    any_mask) or "closest"."""
    return "any_hit" if any_hit else "closest" if any_mask is None else "mixed"


intersect_wide_cuda.launches = 0
intersect_wide_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
intersect_wide_cuda.launches_by_mode = dict.fromkeys(MODES, 0)
intersect_wide_cuda.launches_by_design = dict.fromkeys(GLOBAL_DESIGNS, 0)


def intersect_wide_pool_cuda(table: Tensor, rays: Rays, any_hit: bool = False,
                             stack_depth: int = STACK_DEPTH,
                             max_iters: int = MAX_ITERS, roots: Tensor = None,
                             with_iters: bool = False, any_mask: Tensor = None,
                             with_util: bool = False, _variant: str = None,
                             _scratch: Tensor = None):
    """Launch K4 (``csrc/traversal_pool.cu``) on the current stream: K1's
    signature, checks and outputs, bit for bit, for any order of the rays.
    Rows come from shared memory where the table fits (``launch_variant``;
    `_variant` forces one). The queue counter is in the stream's work area
    (``stream_group_work``: no memset and no scratch tensor a launch), or
    in `_scratch`, a new one (``group_work(0, dev)``), whose
    ``GROUP_COUNTERS`` and ``work_util`` then read. With `with_util` (and
    with_iters) the kernel's own count of its lane slots is returned.
    Each launch adds one to ``intersect_wide_pool_cuda.launches``."""
    args, out = _wide_args(table, rays, any_hit, stack_depth, max_iters, roots,
                           any_mask)
    variant = launch_variant(table, _variant)
    work, count_set = _work_area(rays.o.shape[0], table.device, False, _scratch)
    fn = cuda_build.load_library("traversal_pool.cu").ctl_traverse_pool
    fn.argtypes = _WIDE_ARGTYPES + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, _ptr(work), count_set, VARIANTS[variant],
             _stream(table.device))
    res = _wide_result(err, out, with_iters,
                       _kernel_slots(work, count_set, with_util and with_iters),
                       table.device if _scratch is None else None)
    intersect_wide_pool_cuda.launches += 1
    return res


intersect_wide_pool_cuda.launches = 0


def pool_schedule() -> tuple:
    """(the idle lanes a warp of K4 waits for before it claims rays, the
    fetches a lane makes in one iteration while it draws dead rays):
    ``kFetchIdle`` and ``kFetchRounds`` of ``csrc/traversal_pool.cu`` (builds
    the library)."""
    fn = cuda_build.load_library("traversal_pool.cu").ctl_pool_schedule
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 2)()
    fn(out)
    return out[0], out[1]


def intersect_wide_pool(table: Tensor, rays: Rays, any_hit: bool = False,
                        stack_depth: int = STACK_DEPTH,
                        max_iters: int = MAX_ITERS, roots: Tensor = None,
                        with_iters: bool = False, any_mask: Tensor = None,
                        with_util: bool = False):
    """The pool traversal (JAX ``traversal_pl.intersect_pallas_pool``): K4
    for a CUDA table; for a CPU table its plain version, which is
    ``intersect_wide`` (K4 computes K1's function; its slots with
    `with_util` are then K1's static schedule's). Same signature and
    outputs as ``intersect_wide``."""
    fn = _wide_fn(table, pool=True)
    return fn(table, rays, any_hit=any_hit, stack_depth=stack_depth,
              max_iters=max_iters, roots=roots, with_iters=with_iters,
              any_mask=any_mask, with_util=with_util)


V_COHERENT = 6     # treelet visit budget of camera rays
V_INCOHERENT = 3   # of bounce and shadow rays


def treelet_would_dispatch(geom, coherent: bool = True,
                           roots: Tensor = None) -> bool:
    """True iff intersect_scene routes this geometry and wavefront onto the
    two-phase treelet traversal: a flat table with treelet tables and no
    per-ray roots. Shared with models/path.py's depth-0 peel."""
    return geom.inst is None and geom.tt_top is not None and roots is None


def intersect_scene(geom, rays: Rays, any_hit: bool = False,
                    roots: Tensor = None, with_iters: bool = False,
                    coherent: bool = False, any_mask: Tensor = None):
    """Production intersector over a GeometryTable's fat-row table.

    An instanced scene (``geom.inst``) goes to the two-level traversal
    (``ops/instanced.intersect_instanced``): its hit carries local triangle
    ids and the instance id in ``hit.inst``. A flat table with treelet
    tables goes to the two-phase treelet traversal
    (``intersect_treelet_exact``: K2, K3 and the K1 fallback on CUDA, their
    plain versions on the CPU); `coherent` picks its visit budget
    (V_COHERENT for camera rays, V_INCOHERENT otherwise). Any other table
    goes, when it is a CUDA table of any size, to K1 (``intersect_wide_cuda``),
    and on the CPU to its plain version (``intersect_wide``). No render path
    takes the pool kernel K4 (``intersect_wide_pool``): the JAX dispatch
    picks it only under a switch that is off by default.

    with_iters=True returns (hit, iters, rows, ovf), all int64 counters:
    iters is the sum of the steps of every kernel the rays went through,
    rows the 512-byte rows they read (one per step, so equal to iters), and
    ovf a (2,) tensor holding the number of capped rays and visits and of
    rays and visits whose stack overflowed. The call is the span
    ``ctl.traverse`` (``utils/timers``); an instanced scene's BLAS visits
    nest theirs inside it."""
    with timers.span("ctl.traverse"):
        # the kernels take contiguous rays; camera rays share one expanded origin
        rays = Rays(*(x.contiguous() for x in rays))
        if geom.inst is not None:
            from . import instanced
            return instanced.intersect_instanced(geom, rays, any_hit=any_hit,
                                                 with_iters=with_iters,
                                                 any_mask=any_mask)
        if treelet_would_dispatch(geom, coherent=coherent, roots=roots):
            return intersect_treelet_exact(geom, rays, any_hit=any_hit,
                                           coherent=coherent,
                                           with_iters=with_iters,
                                           any_mask=any_mask)
        res = _wide_fn(geom.wide)(geom.wide, rays, any_hit=any_hit,
                                  roots=roots, with_iters=with_iters,
                                  any_mask=any_mask)
        if not with_iters:
            return res
        hit, steps, flags = res
        counts = _step_and_flag_counts(steps, flags)
        return hit, counts[0], counts[0], counts[1:]


def _wide_fn(table: Tensor, pool: bool = False):
    if table.is_cuda:
        return intersect_wide_pool_cuda if pool else intersect_wide_cuda
    if table.device.type == "cpu":
        return intersect_wide
    raise ValueError(f"no traversal for a table on {table.device}")


def _flag_counts(flags: Tensor) -> Tensor:
    """(2,) int64: the lanes whose flags hold FLAG_CAPPED and FLAG_OVERFLOW
    (three launches on the card)."""
    bits, div = _count_rows(flags.device)
    return (flags & bits[1:]).sum(1) // div[1:]


def _step_and_flag_counts(steps: Tensor, flags: Tensor) -> Tensor:
    """(3,) int64: the steps of a call's rays and ``_flag_counts``, from one
    reduction over the rows [steps, flags & FLAG_CAPPED, flags &
    FLAG_OVERFLOW] (four launches on the card)."""
    bits, div = _count_rows(flags.device)
    rows = flags & bits
    rows[0] += steps
    return rows.sum(1) // div


@functools.lru_cache(maxsize=None)
def _count_rows(dev):
    """The count rows' flag bits, int64 so that the rows sum with no cast
    (row 0, the steps, takes none), and each row's divisor."""
    bits = torch.tensor([[0], [FLAG_CAPPED], [FLAG_OVERFLOW]], dtype=torch.int64, device=dev)
    return bits, bits[:, 0].clamp_min(1)


def intersect_treelet_exact(geom, rays: Rays, any_hit: bool = False,
                            coherent: bool = False, with_iters: bool = False,
                            roots: Tensor = None, roots_top: Tensor = None,
                            any_mask: Tensor = None):
    """Treelet two-phase traversal plus its exactness fallback.

    Shared by the flat dispatch above and the instanced BLAS visits
    (``ops/instanced.py``): with per-lane `roots_top` (top-local start
    rows, ``InstanceTable.root_top``) each ray traverses its own BLAS of
    the split forest in phase 1, and `roots` gives the matching global rows
    of ``geom.wide``, where the fallback starts. Both or neither.

    Rays whose visit list overflowed the V budget in a way that may hide a
    closer hit (``intersect_treelet``'s overflow mask) are re-traversed on
    the whole table by K1 (on the CPU, its plain version), with tmax = their
    treelet t. The fallback always runs over the whole batch, with no host
    read of the count: every other ray gets tmax -1, which no box or
    triangle can meet, so it is a dead lane of one step. Without per-lane
    roots, on a table too large for shared memory, K1 runs the group design
    here (``FALLBACK_DESIGN``): it writes the dead lanes without reading
    the table and compacts the live rays into a queue inside the launch,
    the counterpart of the JAX package's compaction ladder and persistent
    lanes. A fallback hit is closer than the treelet t by construction and
    wins outright."""
    from . import traversal_tt
    if (roots is None) != (roots_top is None):
        raise ValueError("roots and roots_top go together")
    res = traversal_tt.intersect_treelet(
        geom.tt_top, geom.tt_slabs, rays, any_hit=any_hit,
        V=V_COHERENT if coherent else V_INCOHERENT,
        with_overflow=True, with_iters=with_iters, any_mask=any_mask,
        roots=roots_top)
    hit, ovf = res[0], res[1]
    fb_rays = Rays(o=rays.o, d=rays.d, tmin=rays.tmin,
                   tmax=torch.where(ovf, hit.t, -1.0))
    design = dict(_design=FALLBACK_DESIGN) \
        if geom.wide.is_cuda and roots is None else {}
    fb, fb_steps, fb_flags = _wide_fn(geom.wide)(
        geom.wide, fb_rays, any_hit=any_hit, with_iters=True, roots=roots,
        any_mask=any_mask, **design)
    win = fb.valid & ovf
    hit = Hit(t=torch.where(win, fb.t, hit.t),
              tri=torch.where(win, fb.tri, hit.tri),
              u=torch.where(win, fb.u, hit.u),
              v=torch.where(win, fb.v, hit.v))
    if not with_iters:
        return hit
    iters = res[2] + fb_steps.sum(dtype=torch.int64)
    return hit, iters, iters, res[4] + _flag_counts(fb_flags)
