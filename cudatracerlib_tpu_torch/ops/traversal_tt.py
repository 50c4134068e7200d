"""Two-phase treelet traversal for large scenes.

Port of ``cudatracerlib_tpu/ops/traversal_tt.py``. A table of more than
2,048 rows is split into a top table and treelet slabs (scene/treelet.py);
``intersect_treelet`` traverses the two:

  phase 1  K2 traverses the top table, one thread per ray: real top-level
           leaves give hits, and each virtual leaf is a visit of one cut
           subtree. Each ray keeps its V visits with the smallest entry t,
           counts them all, and tracks the smallest entry t it dropped.
  sort     the B*V visit slots by packed key (tid << 14 | root), so that
           neighbouring K3 threads read the same slab.
  phase 2  K3 traverses one slab per visit, one thread per slot, from the
           visit's local root, pruned by the ray's phase-1 t. Any-hit rays
           already hit in phase 1 are killed first (tmax -1).
  reduce   each ray's V visit hits to the nearest, merged with phase 1.

Each kernel has a wrapper that takes CUDA tensors only (``top_visits_cuda``,
``treelet_hits_cuda``, each counting its launches) and a plain PyTorch
version with the same per-ray semantics, step counts and flags
(``top_visits``, ``treelet_hits``), which serves CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them. The glue is plain torch on
both devices: no host read and no data-dependent shape, so the CUDA path
never waits on the card. The TPU's block padding, per-treelet block
geometry and slot transposes existed for BlockSpec DMA and are not carried
over.

Without cross-treelet t sharing, a visit prunes only with the phase-1 t;
a ray whose dropped visits start before its final hit may have missed a
closer one: ``with_overflow`` returns those rays, and
``ops/traversal8.intersect_treelet_exact`` re-traverses them.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .traversal import Hit, Rays
from .traversal8 import (MAX_ITERS, STACK_DEPTH, VARIANTS, _check_args,
                         _check_rays, _check_table, _flag_counts, _lockstep,
                         _mask_u8, _ptr, _require, any_lanes, launch_variant,
                         queue_counter)
from ..scene.treelet import VID_ROOT_BITS

Tensor = torch.Tensor

DEFAULT_V = 6
KERNEL_V = (3, 6)  # the V that csrc/traversal_tt.cu instantiates K2 for
_INF = float("inf")


# ---------------------------------------------------------------- K2 ------

def top_visits(top: Tensor, rays: Rays, V: int = DEFAULT_V,
               any_hit: bool = False, any_mask: Tensor = None,
               stack_depth: int = STACK_DEPTH, max_iters: int = MAX_ITERS):
    """Plain version of K2: phase 1 over the (R_top, 128) top table.

    Returns (hit, vids (B, V) i32 packed visit keys, -1 unused; vent (B, V)
    entry ts, 0 unused; vcnt (B,) i32 visits met; mdrop (B,) smallest
    dropped entry t, inf if none; steps (B,) i32; flags (B,) uint8)."""
    _check_args(any_hit, stack_depth, any_mask)
    if top.is_cuda:
        top_visits.cuda_calls += 1
    B, dev = rays.o.shape[0], top.device
    cur = torch.full((B,), 0xFF, dtype=torch.int32, device=dev)
    hit, steps, flags, (vids, vent, vcnt, mdrop) = _lockstep(
        top, rays, cur, rays.tmax, any_lanes(B, any_hit, any_mask, dev),
        stack_depth, max_iters, n_real=top.shape[0], V=V)
    return hit, vids, vent, vcnt, mdrop, steps, flags


top_visits.cuda_calls = 0   # calls that got CUDA tensors (comparisons only)


def _lib():
    return cuda_build.load_library("traversal_tt.cu")


def top_visits_cuda(top: Tensor, rays: Rays, V: int = DEFAULT_V,
                    any_hit: bool = False, any_mask: Tensor = None,
                    stack_depth: int = STACK_DEPTH,
                    max_iters: int = MAX_ITERS, _variant: str = None):
    """Launch K2 (``csrc/traversal_tt.cu``) on the current stream: the same
    signature, results, step counts and flags as ``top_visits``. Takes
    CUDA tensors only and raises on anything else, on a V outside
    ``KERNEL_V`` and when the card refuses the launch. The variant comes
    from the top table's size, as K1's (``traversal8.launch_variant``;
    `_variant` forces one). Each launch adds one to
    ``top_visits_cuda.launches``, to ``top_visits_cuda.launches_by_v[V]``
    and to ``top_visits_cuda.launches_by_variant[variant]``."""
    _check_table(top, "top")
    variant = launch_variant(top, _variant)
    res = launch_top(_lib().ctl_top_visits, VARIANTS[variant],
                     queue_counter(variant, top.device), top, rays, V,
                     any_hit, any_mask, stack_depth, max_iters)
    top_visits_cuda.launches += 1
    top_visits_cuda.launches_by_v[V] += 1
    top_visits_cuda.launches_by_variant[variant] += 1
    return res


def launch_top(fn, code: int, counter: Tensor, top: Tensor, rays: Rays,
               V: int, any_hit: bool, any_mask: Tensor, stack_depth: int,
               max_iters: int):
    """Check K2's arguments, allocate its outputs and call `fn`, a C entry
    with ``ctl_top_visits``'s arguments, with `code` (the variant) and
    `counter` (the queue counter, or None); raises on an error. Returns
    ``top_visits``'s outputs."""
    _check_args(any_hit, stack_depth, any_mask)
    if V not in KERNEL_V:
        raise ValueError(f"K2 is built for V in {KERNEL_V}, not {V}")
    _check_table(top, "top")
    dev = top.device
    B = _check_rays(rays, dev)
    mask_u8 = _mask_u8(any_mask, B, dev)
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    t, u, v = (torch.empty(B, **f32) for _ in range(3))
    tri, steps, vcnt = (torch.empty(B, **i32) for _ in range(3))
    flags = torch.empty(B, dtype=torch.uint8, device=dev)
    vids = torch.empty((B, V), **i32)
    vent = torch.empty((B, V), **f32)
    mdrop = torch.empty(B, **f32)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
    fn.restype = ci
    err = fn(_ptr(top), top.shape[0], _ptr(rays.o), _ptr(rays.d),
             _ptr(rays.tmin), _ptr(rays.tmax), _ptr(mask_u8), B,
             int(bool(any_hit)), V, stack_depth, max_iters, _ptr(t), _ptr(tri),
             _ptr(u), _ptr(v), _ptr(steps), _ptr(flags), _ptr(vids),
             _ptr(vent), _ptr(vcnt), _ptr(mdrop), _ptr(counter), code,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"K2 (top_visits) launch failed: error {err}")
    return Hit(t=t, tri=tri, u=u, v=v), vids, vent, vcnt, mdrop, steps, flags


top_visits_cuda.launches = 0
top_visits_cuda.launches_by_v = dict.fromkeys(KERNEL_V, 0)
top_visits_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------- K3 ------

def treelet_hits(slabs: Tensor, rays: Rays, t_prune: Tensor, keys: Tensor,
                 order: Tensor, V: int, any_hit: bool = False,
                 any_mask: Tensor = None, stack_depth: int = STACK_DEPTH,
                 max_iters: int = MAX_ITERS):
    """Plain version of K3: phase 2 over the (n_treelets, rows, 128) slabs.

    keys: (S,) i32 packed visit keys (tid << 14 | root) in the order to
    run; order: (S,) i32 the flat slot (ray * V + j) each one belongs to;
    t_prune: (B,) each ray's tmax. Slots whose tid is past the last treelet
    are invalid and do not run. Returns (hit, steps, flags), each (S,) and
    indexed by flat slot; an invalid slot holds t=inf, tri=-1, 0 steps."""
    _check_args(any_hit, stack_depth, any_mask)
    if slabs.is_cuda:
        treelet_hits.cuda_calls += 1
    n_tt, rows = slabs.shape[0], slabs.shape[1]
    dev = slabs.device
    order = order.long()
    ray = order // V
    tid = keys >> VID_ROOT_BITS
    valid = tid < n_tt
    root = keys & ((1 << VID_ROOT_BITS) - 1)
    vr = Rays(o=rays.o[ray], d=rays.d[ray], tmin=rays.tmin[ray],
              tmax=torch.where(valid, t_prune[ray], _INF))
    cur = torch.where(valid, (root << 8) | 0xFF, -1).to(torch.int32)
    anyh = any_lanes(rays.o.shape[0], any_hit, any_mask, dev)[ray]
    hit, steps, flags, _ = _lockstep(
        slabs.reshape(-1, 128), vr, cur, vr.tmax, anyh, stack_depth,
        max_iters, base=tid.clamp(0, n_tt - 1).long() * rows, n_rows=rows)
    S = keys.shape[0]

    def unsort(x):
        out = torch.empty(S, dtype=x.dtype, device=dev)
        out[order] = x
        return out
    return (Hit(t=unsort(hit.t), tri=unsort(hit.tri), u=unsort(hit.u),
                v=unsort(hit.v)), unsort(steps), unsort(flags))


treelet_hits.cuda_calls = 0


def treelet_hits_cuda(slabs: Tensor, rays: Rays, t_prune: Tensor,
                      keys: Tensor, order: Tensor, V: int,
                      any_hit: bool = False, any_mask: Tensor = None,
                      stack_depth: int = STACK_DEPTH,
                      max_iters: int = MAX_ITERS):
    """Launch K3 (``csrc/traversal_tt.cu``) on the current stream over all
    S visit slots: the same signature, results, step counts and flags as
    ``treelet_hits``. Takes CUDA tensors only and raises on anything else.
    Each launch adds one to ``treelet_hits_cuda.launches`` and to
    ``treelet_hits_cuda.launches_by_v[V]``."""
    _check_args(any_hit, stack_depth, any_mask)
    if V not in KERNEL_V:
        raise ValueError(f"K3 runs on K2's visit slots: V in {KERNEL_V}, not {V}")
    _check_table(slabs, "slabs", 2)
    dev = slabs.device
    B = _check_rays(rays, dev, with_tmax=False)
    S = keys.shape[0]
    if S != B * V:
        raise ValueError(f"{S} visit slots for {B} rays of {V} visits")
    _require(t_prune, "t_prune", torch.float32, (B,), dev)
    _require(keys, "keys", torch.int32, (S,), dev)
    _require(order, "order", torch.int32, (S,), dev)
    mask_u8 = _mask_u8(any_mask, B, dev)
    t, u, v = (torch.empty(S, dtype=torch.float32, device=dev) for _ in range(3))
    tri, steps = (torch.empty(S, dtype=torch.int32, device=dev) for _ in range(2))
    flags = torch.empty(S, dtype=torch.uint8, device=dev)
    fn = _lib().ctl_treelet_hits
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, ci, vp, vp, ci, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    err = fn(_ptr(slabs), slabs.shape[0], slabs.shape[1], _ptr(rays.o),
             _ptr(rays.d), _ptr(rays.tmin), _ptr(t_prune), _ptr(mask_u8),
             int(bool(any_hit)), _ptr(keys), _ptr(order), S, V, stack_depth,
             max_iters, _ptr(t), _ptr(tri), _ptr(u), _ptr(v), _ptr(steps),
             _ptr(flags),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"K3 (treelet_hits) launch failed: error {err}")
    treelet_hits_cuda.launches += 1
    treelet_hits_cuda.launches_by_v[V] += 1
    return Hit(t=t, tri=tri, u=u, v=v), steps, flags


treelet_hits_cuda.launches = 0
treelet_hits_cuda.launches_by_v = dict.fromkeys(KERNEL_V, 0)


# ---------------------------------------------------------------- glue ----

def _kernels(top: Tensor):
    """(phase-1, phase-2) functions for the tables' device: the kernels for
    CUDA tensors, their plain versions for CPU tensors."""
    if top.is_cuda:
        return top_visits_cuda, treelet_hits_cuda
    if top.device.type == "cpu":
        return top_visits, treelet_hits
    raise ValueError(f"no treelet traversal for tables on {top.device}")


def intersect_treelet(top: Tensor, slabs: Tensor, rays: Rays,
                      any_hit: bool = False, V: int = DEFAULT_V,
                      with_iters: bool = False, with_overflow: bool = False,
                      any_mask: Tensor = None):
    """Two-phase treelet traversal of (top (R_top, 128), slabs (n_treelets,
    rows, 128)): the kernels on CUDA tables, their plain versions on CPU
    tables.

    Returns the hit; with with_overflow also a (B,) bool of the rays whose
    hit may be incomplete (the caller re-traverses them); with with_iters
    also the int64 step count of both phases, the rows read (one per step,
    so equal) and a (2,) int64 count of (capped, stack-overflowed) visits
    and rays."""
    return two_phase(*_kernels(top), top, slabs, rays, any_hit=any_hit, V=V,
                     with_iters=with_iters, with_overflow=with_overflow,
                     any_mask=any_mask)


def two_phase(phase1, phase2, top: Tensor, slabs: Tensor, rays: Rays,
              any_hit: bool = False, V: int = DEFAULT_V,
              with_iters: bool = False, with_overflow: bool = False,
              any_mask: Tensor = None):
    """``intersect_treelet`` with the two phases given: (top_visits,
    treelet_hits) or their kernels. ``chip_smoke.py`` runs the plain pair on
    CUDA tensors to hold the kernels' path against it."""
    _check_args(any_hit, STACK_DEPTH, any_mask)
    B, dev = rays.o.shape[0], top.device
    hit1, vids, _, vcnt, mdrop, steps1, flags1 = phase1(
        top, rays, V, any_hit=any_hit, any_mask=any_mask)
    valid, keys, order, t_prune = visit_slots(
        hit1, vids, vcnt, slabs.shape[0], any_lanes(B, any_hit, any_mask, dev))
    hits, steps2, flags2 = phase2(slabs, rays, t_prune, keys, order, V,
                                  any_hit=any_hit, any_mask=any_mask)

    # reduce each ray's V visits to the nearest (lowest slot on ties), then
    # merge with phase 1
    t_v = hits.t.reshape(B, V)
    tri_v = hits.tri.reshape(B, V)
    t_v = torch.where(valid & (tri_v >= 0), t_v, _INF)
    t_r = torch.full((B,), _INF, dtype=torch.float32, device=dev)
    j_r = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for j in range(V):
        closer = t_v[:, j] < t_r
        t_r = torch.where(closer, t_v[:, j], t_r)
        j_r = torch.where(closer[:, None], j, j_r)
    better = t_r < hit1.t
    pick = lambda x: x.reshape(B, V).gather(1, j_r)[:, 0]
    hit = Hit(t=torch.where(better, t_r, hit1.t),
              tri=torch.where(better, pick(hits.tri), hit1.tri),
              u=torch.where(better, pick(hits.u), hit1.u),
              v=torch.where(better, pick(hits.v), hit1.v))
    out = (hit,)
    if with_overflow:
        # a dropped visit can hide a closer hit only if its entry t is below
        # the final t; the kept set is the V nearest, so the smallest dropped
        # entry is the tightest bound. Any-hit lanes with a hit are answered;
        # those without one must re-traverse (any dropped subtree could
        # occlude).
        ovf = vcnt > V
        gate = mdrop < hit.t
        if any_hit:
            ovf = ovf & (hit.tri < 0)
        elif any_mask is not None:
            ovf = ovf & ~(any_mask & (hit.tri >= 0))
            ovf = ovf & torch.where(any_mask, True, gate)
        else:
            ovf = ovf & gate
        out = out + (ovf,)
    if with_iters:
        iters = steps1.sum(dtype=torch.int64) + steps2.sum(dtype=torch.int64)
        out = out + (iters, iters, _flag_counts(flags1) + _flag_counts(flags2))
    return out if len(out) > 1 else hit


def visit_slots(hit1: Hit, vids: Tensor, vcnt: Tensor, n_treelets: int,
                anyh: Tensor):
    """Phase 2's inputs from phase 1's output: the (B, V) mask of kept
    visits, every (ray, j) slot's packed key sorted ascending (invalid slots
    carry n_treelets << 14 and sort last) with the flat slot each came from
    (i32), and each ray's prune t. A found hit fully answers an any-hit
    query, so an any-hit ray already hit gets t -1 and its visits die in
    one step."""
    V = vids.shape[1]
    valid = (torch.arange(V, device=vids.device)[None, :]
             < vcnt.clamp_max(V)[:, None])
    keys = torch.where(valid, vids, n_treelets << VID_ROOT_BITS).reshape(-1)
    keys, order = torch.sort(keys)
    t_prune = torch.where(anyh & (hit1.tri >= 0), -1.0, hit1.t)
    return valid, keys, order.to(torch.int32), t_prune


def count_dropped_visits(top: Tensor, rays: Rays, V: int = DEFAULT_V,
                         max_iters: int = MAX_ITERS):
    """Run phase 1 only (closest hit) and return int64 (total visits,
    visits dropped past V)."""
    phase1, _ = _kernels(top)
    vcnt = phase1(top, rays, V, max_iters=max_iters)[3]
    return (vcnt.sum(dtype=torch.int64),
            (vcnt - V).clamp_min(0).sum(dtype=torch.int64))
