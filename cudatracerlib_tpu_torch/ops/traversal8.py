"""Wide (8-ary) BVH traversal over the fat-row table.

Port of ``cudatracerlib_tpu/ops/traversal8.py``. Three implementations of
one traversal, with the same per-ray semantics, step counts and flags:

- ``intersect_wide_cuda``: the wrapper of the hand-written Hopper kernel K1,
  ``csrc/traversal8.cu``, which replaces the TPU kernel
  ``cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel``. It takes CUDA
  tensors only. A table that fits a block's shared memory
  (``table_variant``) runs the shared variant: one block per SM holds the
  table; a larger one runs the global variant, rows from device memory.
- ``intersect_wide_pool_cuda``: the wrapper of K4, ``csrc/traversal_pool.cu``,
  which replaces the TPU kernel ``traversal_pl.py::_traverse_kernel_pool``:
  persistent warps that take rays from a global queue. It computes exactly
  K1's function and only schedules rays differently, so its plain version
  is ``intersect_wide`` itself. CUDA tensors only.
- ``intersect_wide``: the plain PyTorch version of both, a lockstep batch
  loop like the JAX ``intersect_wide`` (``_lockstep``, shared with the
  plain versions of K2 and K3). It serves CPU tensors, and the tests and
  ``chip_smoke.py`` hold the kernels against it.

``intersect_scene`` sends a table with treelet tables to the two-phase
treelet traversal (``ops/traversal_tt.py``) with K1 as its exactness
fallback, and any other table by its device to K1 or to the plain version.
K4 is called only through ``intersect_wide_pool``.

Per ray: a stack entry is (row << 8) | unvisited-child mask; the stack is a
ring of ``stack_depth`` entries that drops its oldest entry when a push
finds it full (flag bit 1); a ray still running after ``max_iters`` steps
keeps its best hit so far (flag bit 0). One step fetches one 512-byte row,
so a ray's step count is also its count of rows read. These are per-ray
counts, not the TPU kernel's lockstep iterations.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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
# the launch variants of K1 and K2, by their C entries' codes
VARIANTS = {"global": 0, "shared": 1}
# float32 operations of a node step, counted from csrc/bvh8_traverse.cuh:
# 26 per child (6 subtractions and 6 products for the slab distances, 12
# min/max, 2 compares) for 8 children. A leaf step does more (about 54 per
# triangle for 12 triangles), so steps times this is a lower bound.
NODE_STEP_FLOPS = 26 * 8


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


def intersect_wide(table: Tensor, rays: Rays, any_hit: bool = False,
                   stack_depth: int = STACK_DEPTH,
                   max_iters: int = MAX_ITERS, roots: Tensor = None,
                   with_iters: bool = False, any_mask: Tensor = None):
    """Plain PyTorch traversal of the (R, 128) fat-row table.

    any_mask: optional (B,) bool giving per-lane any-hit semantics (lanes
    True stop at their first leaf hit), so one call traces a mixed
    closest+shadow wavefront. Returns a Hit, or with with_iters
    (hit, steps (B,) int32, flags (B,) uint8)."""
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
    """The variant of K1 or K2 for a table of `rows` fat rows on a card whose
    blocks may opt in to `shared_limit` bytes of shared memory: "shared"
    when the table fits (rows x ROW_BYTES bytes, the shared variant's only
    shared memory), else "global"."""
    return "shared" if rows * ROW_BYTES <= shared_limit else "global"


@functools.lru_cache(maxsize=None)
def _shared_limit(index: int) -> int:
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def launch_variant(table: Tensor, forced: str = None) -> str:
    """The variant a K1 or K2 launch on `table` ((R, 128), CUDA) takes:
    ``table_variant`` of its rows and its card's opt-in shared-memory limit,
    or `forced` (a test hook: chip_smoke.py and the gpu tests run every
    variant on the same rays)."""
    if forced is not None:
        if forced not in VARIANTS:
            raise ValueError(f"no K1/K2 variant {forced!r}: one of {list(VARIANTS)}")
        return forced
    return table_variant(table.shape[0], _shared_limit(table.device.index))


def queue_counter(variant: str, dev):
    """The ray queue counter a K1 or K2 launch of `variant` needs: an int32
    scratch tensor for the shared variant (its C entry zeroes it on the
    stream), None for the global one."""
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


def _wide_result(err: int, out, with_iters: bool):
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    t, tri, u, v, steps, flags = out
    hit = Hit(t=t, tri=tri, u=u, v=v)
    if with_iters:
        return hit, steps, flags
    return hit


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def intersect_wide_cuda(table: Tensor, rays: Rays, any_hit: bool = False,
                        stack_depth: int = STACK_DEPTH,
                        max_iters: int = MAX_ITERS, roots: Tensor = None,
                        with_iters: bool = False, any_mask: Tensor = None,
                        _variant: str = None):
    """Launch K1 (``csrc/traversal8.cu``) on the current stream: the same
    signature, results, step counts and flags as ``intersect_wide``.

    Takes CUDA tensors only: (R, 128) float32 table; rays o, d (B, 3) and
    tmin, tmax (B,) float32; roots (B,) int32; any_mask (B,) bool. Raises on
    anything else, and when the card refuses the launch. The variant comes
    from the table's size (``launch_variant``; `_variant` forces one); the
    shared variant's ray queue counter is an int32 scratch tensor allocated
    here (``queue_counter``). Each launch adds one to
    ``intersect_wide_cuda.launches``, to
    ``intersect_wide_cuda.launches_by_variant[variant]`` and to
    ``intersect_wide_cuda.launches_by_mode[mode]`` (``launch_mode``)."""
    args, out = _wide_args(table, rays, any_hit, stack_depth, max_iters, roots,
                           any_mask)
    variant = launch_variant(table, _variant)
    counter = queue_counter(variant, table.device)
    fn = cuda_build.load_library("traversal8.cu").ctl_traverse8
    fn.argtypes = _WIDE_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = _wide_result(fn(*args, _ptr(counter), VARIANTS[variant],
                          _stream(table.device)), out, with_iters)
    intersect_wide_cuda.launches += 1
    intersect_wide_cuda.launches_by_variant[variant] += 1
    intersect_wide_cuda.launches_by_mode[launch_mode(any_hit, any_mask)] += 1
    return res


MODES = ("closest", "any_hit", "mixed")


def launch_mode(any_hit: bool, any_mask: Tensor = None) -> str:
    """A traversal's mode: "any_hit" (every lane), "mixed" (per-lane
    any_mask) or "closest"."""
    return "any_hit" if any_hit else "closest" if any_mask is None else "mixed"


intersect_wide_cuda.launches = 0
intersect_wide_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
intersect_wide_cuda.launches_by_mode = dict.fromkeys(MODES, 0)


def intersect_wide_pool_cuda(table: Tensor, rays: Rays, any_hit: bool = False,
                             stack_depth: int = STACK_DEPTH,
                             max_iters: int = MAX_ITERS, roots: Tensor = None,
                             with_iters: bool = False, any_mask: Tensor = None):
    """Launch K4 (``csrc/traversal_pool.cu``) on the current stream: K1's
    signature, checks and outputs, bit for bit, for any order of the rays.
    Its queue counter is an int32 scratch tensor allocated here; the C entry
    zeroes it on the stream before the launch. Each launch adds one to
    ``intersect_wide_pool_cuda.launches``."""
    args, out = _wide_args(table, rays, any_hit, stack_depth, max_iters, roots,
                           any_mask)
    counter = torch.empty(1, dtype=torch.int32, device=table.device)
    fn = cuda_build.load_library("traversal_pool.cu").ctl_traverse_pool
    fn.argtypes = _WIDE_ARGTYPES + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    res = _wide_result(fn(*args, _ptr(counter), _stream(table.device)), out,
                       with_iters)
    intersect_wide_pool_cuda.launches += 1
    return res


intersect_wide_pool_cuda.launches = 0


def intersect_wide_pool(table: Tensor, rays: Rays, any_hit: bool = False,
                        stack_depth: int = STACK_DEPTH,
                        max_iters: int = MAX_ITERS, roots: Tensor = None,
                        with_iters: bool = False, any_mask: Tensor = None):
    """The pool traversal (JAX ``traversal_pl.intersect_pallas_pool``): K4
    for a CUDA table; for a CPU table its plain version, which is
    ``intersect_wide`` (K4 computes K1's function). Same signature and
    outputs as ``intersect_wide``."""
    fn = _wide_fn(table, pool=True)
    return fn(table, rays, any_hit=any_hit, stack_depth=stack_depth,
              max_iters=max_iters, roots=roots, with_iters=with_iters,
              any_mask=any_mask)


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

    A table with treelet tables goes to the two-phase treelet traversal
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
    rays and visits whose stack overflowed."""
    if geom.inst is not None:
        raise NotImplementedError("instanced scenes are not ported yet")
    # the kernels take contiguous rays; camera rays share one expanded origin
    rays = Rays(*(x.contiguous() for x in rays))
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
    iters = steps.sum(dtype=torch.int64)
    return hit, iters, iters, _flag_counts(flags)


def _wide_fn(table: Tensor, pool: bool = False):
    if table.is_cuda:
        return intersect_wide_pool_cuda if pool else intersect_wide_cuda
    if table.device.type == "cpu":
        return intersect_wide
    raise ValueError(f"no traversal for a table on {table.device}")


def _flag_counts(flags: Tensor) -> Tensor:
    return torch.stack([(flags & FLAG_CAPPED).ne(0).sum(),
                        (flags & FLAG_OVERFLOW).ne(0).sum()])


def intersect_treelet_exact(geom, rays: Rays, any_hit: bool = False,
                            coherent: bool = False, with_iters: bool = False,
                            any_mask: Tensor = None):
    """Treelet two-phase traversal plus its exactness fallback.

    Rays whose visit list overflowed the V budget in a way that may hide a
    closer hit (``intersect_treelet``'s overflow mask) are re-traversed on
    the whole table by K1 (on the CPU, its plain version), with tmax = their
    treelet t. The fallback always runs over the whole batch, with no host
    read of the count: every other ray gets tmax -1, which no box or
    triangle can meet, so it costs one step. Each ray runs its own thread,
    so the JAX package's compaction ladder is not needed. A fallback hit is
    closer than the treelet t by construction and wins outright."""
    from . import traversal_tt
    res = traversal_tt.intersect_treelet(
        geom.tt_top, geom.tt_slabs, rays, any_hit=any_hit,
        V=V_COHERENT if coherent else V_INCOHERENT,
        with_overflow=True, with_iters=with_iters, any_mask=any_mask)
    hit, ovf = res[0], res[1]
    fb_rays = Rays(o=rays.o, d=rays.d, tmin=rays.tmin,
                   tmax=torch.where(ovf, hit.t, -1.0))
    fb, fb_steps, fb_flags = _wide_fn(geom.wide)(
        geom.wide, fb_rays, any_hit=any_hit, with_iters=True,
        any_mask=any_mask)
    win = fb.valid & ovf
    hit = Hit(t=torch.where(win, fb.t, hit.t),
              tri=torch.where(win, fb.tri, hit.tri),
              u=torch.where(win, fb.u, hit.u),
              v=torch.where(win, fb.v, hit.v))
    if not with_iters:
        return hit
    iters = res[2] + fb_steps.sum(dtype=torch.int64)
    return hit, iters, iters, res[4] + _flag_counts(fb_flags)
