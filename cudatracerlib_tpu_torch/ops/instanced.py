"""Two-level (TLAS/BLAS) instanced traversal.

Port of ``cudatracerlib_tpu/ops/instanced.py``. Reference:
``Engine/SceneBVH.h:18`` (a TLAS over scene nodes) and the inverse-transform
hand-off at TLAS leaves (``Kernel/TraceHelper.cu:88-180``). Each lane
selects the instances its ray enters, nearest first, and the shared BLAS
table is traversed once per visited instance with per-lane root rows,
carrying the closest hit across visits so that later instances are pruned
by the best t.

Two selection routes, as in the JAX package:

- **dense** (fewer than ``host.DynamicScene.TLAS_MIN_INSTANCES``
  instances): a (B, I) slab test against every instance box; I BLAS visits
  per call, each the nearest unvisited instance, with no early exit.
- **TLAS** (``inst.tlas`` present): ``tlas_visits`` walks the 8-wide BVH
  over the instance boxes and emits each lane's visit list (V = 12,
  visits past the budget counted as dropped, never silent:
  ``dropped_visits`` sums them); then V BLAS visits.

A BLAS visit (``_blas_intersect``) runs the scene's kernels with per-lane
roots: on a split forest (``inst.root_top`` and ``geom.tt_top``) the
treelet path, K2 from each ray's top-local root and the K1 fallback from
its global root; otherwise K1 with global roots. On CPU tensors the plain
versions of the same kernels run. The TLAS walk is plain torch, as the
JAX package's is plain jnp: a loop of at most 256 steps whose exit test
reads one bool back from the device each step (``host_reads`` counts
them). Transforms are written as separate multiplies and adds, so the card
and the CPU round them alike.
"""
from __future__ import annotations

import torch

from ..scene import schema
from .traversal import Hit, Rays

Tensor = torch.Tensor

MAX_VISITS = 8
TLAS_VISITS = 12    # visit budget of the TLAS route (max(MAX_VISITS, 12))
TLAS_MAX_ITERS = 256
TLAS_STACK = 12
_DONE, _POP = -1, -0x40000000

host_reads = 0   # the TLAS walk's exit tests read back from the device
# visits past the TLAS route's budget, summed over every intersect_instanced
# call: 0, or an int64 tensor on the scene's device (no host read)
dropped_visits = 0


def _transform_point(m34: Tensor, p: Tensor) -> Tensor:
    """(B,3,4) x (B,3) -> (B,3)."""
    return _transform_dir(m34, p) + m34[:, :, 3]


def _transform_dir(m34: Tensor, d: Tensor) -> Tensor:
    return (m34[:, :, 0] * d[:, 0:1] + m34[:, :, 1] * d[:, 1:2]
            + m34[:, :, 2] * d[:, 2:3])


def _safe_inv_dir(d: Tensor) -> Tensor:
    eps = 1e-12
    safe = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    return 1.0 / safe


def tlas_visits(table: Tensor, order: Tensor, rays: Rays,
                max_visits: int = TLAS_VISITS, with_iters: bool = False):
    """Traverse the 8-wide TLAS over instance AABBs (``scene/bvh8.build_tlas8``)
    and emit each lane's instance visit list in approximate near-to-far
    order. Leaf links carry the binary builder's -2-(first*16+count) codes
    over `order` (leaf-contiguous instance ids).

    Returns (visits (V, B) int32 with -1 padding, counts (B,) int32 clipped
    to V, dropped: the int64 count of visits past the budget); with
    with_iters also the int64 count of lane steps (one 512-byte TLAS row
    read each)."""
    global host_reads
    dev = table.device
    B = rays.o.shape[0]
    V = max_visits
    inv_d = _safe_inv_dir(rays.d)
    ox, oy, oz = (rays.o[:, k:k + 1] for k in range(3))
    ix, iy, iz = (inv_d[:, k:k + 1] for k in range(3))
    tmn, tmx = rays.tmin[:, None], rays.tmax[:, None]
    n_rows, n_order = table.shape[0], order.shape[0]
    bit8 = (1 << torch.arange(8, dtype=torch.int32, device=dev))[None, :]
    slot = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    lanes = torch.arange(B, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    cur = torch.full((B,), 0xFF, **i32)
    sp = torch.zeros(B, **i32)
    stack = torch.zeros((B, TLAS_STACK), **i32)
    visits = torch.full((B, V), -1, **i32)
    vcount = torch.zeros(B, **i32)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < TLAS_MAX_ITERS:
        live = cur != _DONE
        host_reads += 1
        if not bool(live.any()):
            break
        steps = steps + live.sum()
        is_node = cur >= 0
        row = table[torch.where(is_node, cur >> 8, 0).clamp(0, n_rows - 1).long()]
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
            torch.minimum(torch.maximum(t0z, t1z), tmx))
        links = row[:, 48:56].view(torch.int32)
        eligible = (tn <= tf) & (links != _DONE) & (((cur & 0xFF)[:, None] & bit8) != 0)
        t_sel = torch.where(eligible, tn, float("inf"))
        best_t, best_j = t_sel.min(dim=1)       # first index among equal minima
        best_j = best_j.to(torch.int32)
        has_child = torch.isfinite(best_t)
        link_best = links[lanes, best_j.long()]
        elig_bits = (eligible.to(torch.int32) * bit8).sum(1, dtype=torch.int32)
        remaining = elig_bits & ~(1 << best_j)
        descend = torch.where(link_best >= 0, (link_best << 8) | 0xFF, link_best)
        node_next = torch.where(has_child, descend, _POP)
        push = is_node & has_child & (remaining != 0)
        push_val = ((cur >> 8) << 8) | remaining

        # leaf codes: emit up to `count` instances into the visit slots
        is_leaf = cur <= -2
        code = -2 - cur
        first = code >> 4
        count = code & 15
        for j in range(4):          # the builder's leaves hold at most 2
            emit = is_leaf & (j < count)
            inst_id = order[(first + j).clamp(0, n_order - 1).long()]
            m = emit[:, None] & ((vcount + j)[:, None] == slot)
            visits = torch.where(m, inst_id[:, None], visits)
        vcount = torch.where(is_leaf, (vcount + count).clamp_max(127), vcount)

        nxt = torch.where(is_node, node_next, torch.where(is_leaf, _POP, _DONE))
        # a 12-deep shift-register stack: a push past its depth drops the
        # bottom entry, as the JAX walk's does
        stack = torch.where(push[:, None],
                            torch.cat([push_val[:, None], stack[:, :-1]], 1), stack)
        sp = sp + push.to(torch.int32)
        want_pop = nxt == _POP
        can_pop = want_pop & (sp > 0)
        popped = stack[:, 0]
        stack = torch.where(can_pop[:, None],
                            torch.cat([stack[:, 1:], stack[:, -1:]], 1), stack)
        sp = torch.where(can_pop, sp - 1, sp)
        cur = torch.where(want_pop, torch.where(can_pop, popped, _DONE), nxt)
        it += 1
    dropped = (vcount - V).clamp_min(0).sum(dtype=torch.int64)
    out = (visits.T.contiguous(), vcount.clamp_max(V), dropped)
    return out + (steps,) if with_iters else out


def _blas_intersect(geom: schema.GeometryTable, local: Rays, k: Tensor,
                    any_hit: bool, any_mask: Tensor = None):
    """One BLAS visit over the shared forest table with per-lane roots:
    the treelet path (K2 from the top-local roots, K3, the K1 fallback from
    the global roots) when the forest is split, else K1 with global roots.
    Returns intersect_scene's with_iters tuple."""
    from . import traversal8
    g = geom._replace(inst=None)
    inst = geom.inst
    roots = inst.root[k]
    if inst.root_top is not None and g.tt_top is not None:
        return traversal8.intersect_treelet_exact(
            g, local, any_hit=any_hit, coherent=False, with_iters=True,
            roots=roots, roots_top=inst.root_top[k], any_mask=any_mask)
    return traversal8.intersect_scene(g, local, any_hit=any_hit, roots=roots,
                                      with_iters=True, any_mask=any_mask)


def intersect_instanced(geom: schema.GeometryTable, rays: Rays,
                        any_hit: bool = False,
                        max_visits: int = MAX_VISITS,
                        with_iters: bool = False,
                        any_mask: Tensor = None):
    """Closest-hit (or any-hit) over an instanced scene.

    ``any_mask`` (per-lane any-hit, for the merged bounce and shadow
    traversal of models/path.py) threads through every BLAS visit, and
    masked lanes stop visiting instances at their first hit, as a global
    ``any_hit`` call does.

    Returns a Hit with LOCAL triangle ids and the instance id in
    ``hit.inst`` (shading resolves both in fill_dg's instanced branch).
    With ``with_iters`` also intersect_scene's counters, summed over the
    TLAS walk (one row per lane step) and every BLAS visit: (hit, steps,
    rows, (capped, overflowed))."""
    global dropped_visits
    inst = geom.inst
    B = rays.o.shape[0]
    dev = rays.o.device
    if any_hit and any_mask is not None:
        raise ValueError("any_hit and any_mask are exclusive")
    niters = torch.zeros((), dtype=torch.int64, device=dev)
    novf = torch.zeros(2, dtype=torch.int64, device=dev)
    best = Hit(t=rays.tmax, tri=torch.full((B,), -1, dtype=torch.int32, device=dev),
               u=torch.zeros(B, device=dev), v=torch.zeros(B, device=dev),
               inst=torch.full((B,), -1, dtype=torch.int32, device=dev))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    inv_d = _safe_inv_dir(rays.d)

    def visit(k, active, best, done, niters, novf):
        w2l = inst.w2l[k.long()]                                # (B, 3, 4)
        # directions stay UNnormalized, so a local t is the world t
        local = Rays(o=_transform_point(w2l, rays.o), d=_transform_dir(w2l, rays.d),
                     tmin=rays.tmin, tmax=torch.where(active, best.t, 0.0))
        h, it1, _, ov1 = _blas_intersect(geom, local, k, any_hit, any_mask=any_mask)
        better = active & h.valid & (h.t < best.t)
        best = Hit(t=torch.where(better, h.t, best.t),
                   tri=torch.where(better, h.tri, best.tri),
                   u=torch.where(better, h.u, best.u),
                   v=torch.where(better, h.v, best.v),
                   inst=torch.where(better, k, best.inst))
        if any_hit:
            done = done | (active & h.valid)
        elif any_mask is not None:
            done = done | (active & h.valid & any_mask)
        return best, done, niters + it1, novf + ov1

    if inst.tlas is not None:
        V = max(max_visits, TLAS_VISITS)
        visits, counts, dropped, tlas_steps = tlas_visits(
            inst.tlas, inst.tlas_order, rays, max_visits=V, with_iters=True)
        dropped_visits = dropped_visits + dropped
        niters = niters + tlas_steps
        for v in range(V):
            k = visits[v].clamp_min(0)
            valid = (v < counts) & (visits[v] >= 0) & ~done
            # the entry t again, for closest-hit pruning
            t0 = (inst.lo[k.long()] - rays.o) * inv_d
            t1 = (inst.hi[k.long()] - rays.o) * inv_d
            tn = torch.maximum(torch.minimum(t0, t1).amax(-1), rays.tmin)
            tf = torch.minimum(torch.maximum(t0, t1).amin(-1), best.t)
            best, done, niters, novf = visit(k, valid & (tn <= tf), best, done,
                                             niters, novf)
    else:
        # the dense route: slab-test every instance box, (B, I)
        I = inst.root.shape[0]
        t0 = (inst.lo[None, :, :] - rays.o[:, None, :]) * inv_d[:, None, :]
        t1 = (inst.hi[None, :, :] - rays.o[:, None, :]) * inv_d[:, None, :]
        tn = torch.maximum(torch.minimum(t0, t1).amax(-1), rays.tmin[:, None])
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), rays.tmax[:, None])
        t_entry = torch.where(tn <= tf, tn, float("inf"))        # (B, I)
        visited = torch.zeros((B, I), dtype=torch.bool, device=dev)
        cols = torch.arange(I, device=dev)[None, :]
        # up to I visits: nothing is dropped
        for _ in range(I):
            # the nearest unvisited instance whose entry beats the best hit
            t_sel = torch.where(visited, float("inf"), t_entry)
            t_k, k = t_sel.min(dim=-1)            # first index among equal minima
            k = k.to(torch.int32)
            active = ~done & torch.isfinite(t_k) & (t_k <= best.t)
            visited = visited | (cols == k[:, None])
            best, done, niters, novf = visit(k, active, best, done, niters, novf)
    if with_iters:
        return best, niters, niters, novf
    return best
