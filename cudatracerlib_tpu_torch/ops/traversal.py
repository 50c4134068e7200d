"""Ray and hit records, and the binary-BVH traversal.

Port of ``cudatracerlib_tpu/ops/traversal.py``. The render paths traverse
the 8-wide fat-row table (``ops/traversal8.py``); the binary BVH of
``scene/bvh.py`` is traversed here in plain PyTorch, as the JAX module's
lockstep loop: every lane holds a current pointer (node, in-leaf cursor or
done) and a stack, and each iteration takes a masked node step (both child
boxes slab-tested, the far child pushed) or a masked leaf step (one
Moller-Trumbore test). The loop's exit test reads one bool from the device
per iteration. Nodes are (N, 16) f32 rows, triangles (T, 12) f32 rows
[v0, e1, e2, pad] (``pack_tris``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm

Tensor = torch.Tensor

DONE = -1  # also: INVALID child link
STACK_DEPTH = 48
MAX_ITERS = 10_000


class Rays(NamedTuple):
    o: Tensor      # (B, 3)
    d: Tensor      # (B, 3)
    tmin: Tensor   # (B,)
    tmax: Tensor   # (B,)


class Hit(NamedTuple):
    t: Tensor       # (B,) hit distance (tmax if miss)
    tri: Tensor     # (B,) int32 triangle id, -1 if miss
    u: Tensor       # (B,) barycentric
    v: Tensor       # (B,)
    inst: "Tensor | None" = None  # (B,) i32 instance id of two-level scenes

    @property
    def valid(self) -> Tensor:
        return self.tri >= 0


def _safe_inv(d: Tensor) -> Tensor:
    eps = 1e-20
    safe_d = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    return 1.0 / safe_d


def _slab(lo, hi, o, inv_d, tmin, tmax):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), tmin)
    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), tmax)
    return tn <= tf, tn


def moller_trumbore(v0, e1, e2, o, d, tmin, tmax):
    """Returns (valid, t, u, v). All inputs batched (..., 3) / (...,)."""
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    tvec = o - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = ((det.abs() >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return valid, t, u, v


def _bitcast_i32(x: Tensor) -> Tensor:
    return x.contiguous().view(torch.int32)


def intersect_bvh(nodes: Tensor, tris: Tensor, tri_order: Tensor, rays: Rays,
                  any_hit: bool = False, stack_depth: int = STACK_DEPTH,
                  max_iters: int = MAX_ITERS) -> Hit:
    """Closest-hit (or any-hit) intersection of a ray batch against the
    binary BVH (scene/bvh.py's packed nodes)."""
    B, dev = rays.o.shape[0], rays.o.device
    inv_d = _safe_inv(rays.d)
    lane = torch.arange(B, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    POP = torch.tensor(-0x7FFFFFFF, **i32)  # marker: this lane needs to pop
    cur = torch.zeros(B, **i32)              # the root node 0
    sp = torch.zeros(B, **i32)
    stack = torch.full((B, stack_depth), DONE, **i32)
    t_best = rays.tmax.clone()
    tri_best = torch.full((B,), -1, **i32)
    u_best = torch.zeros(B, dtype=torch.float32, device=dev)
    v_best = torch.zeros(B, dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and bool((cur != DONE).any()):
        is_node = cur >= 0
        is_leaf = cur <= -2
        # ---- node step (masked) ----
        row = nodes[cur.clamp_min(0).long()]                          # (B, 16)
        link0, link1 = _bitcast_i32(row[:, 12]), _bitcast_i32(row[:, 13])
        h0, tn0 = _slab(row[:, 0:3], row[:, 3:6], rays.o, inv_d, rays.tmin, t_best)
        h1, tn1 = _slab(row[:, 6:9], row[:, 9:12], rays.o, inv_d, rays.tmin, t_best)
        h0 = h0 & (link0 != DONE)
        h1 = h1 & (link1 != DONE)
        both = h0 & h1
        first_is_0 = tn0 <= tn1
        near = torch.where(first_is_0, link0, link1)
        far = torch.where(first_is_0, link1, link0)
        node_next = torch.where(both, near, torch.where(
            h0, link0, torch.where(h1, link1, POP)))
        push = both & is_node
        slot = sp.clamp_max(stack_depth - 1).long()
        old = stack[lane, slot]
        stack[lane, slot] = torch.where(push, far, old)
        sp = sp + push.to(torch.int32)
        # ---- leaf step (masked): one triangle per iteration ----
        code = -2 - cur
        first = code >> 4
        cnt = code & 15
        tid = tri_order[(first.clamp_min(0) % tri_order.shape[0]).long()]
        trow = tris[tid.long()]                                       # (B, 12)
        valid, t, u, v = moller_trumbore(trow[:, 0:3], trow[:, 3:6], trow[:, 6:9],
                                         rays.o, rays.d, rays.tmin, t_best)
        hit_now = is_leaf & valid
        t_best = torch.where(hit_now, t, t_best)
        tri_best = torch.where(hit_now, tid, tri_best)
        u_best = torch.where(hit_now, u, u_best)
        v_best = torch.where(hit_now, v, v_best)
        leaf_next = torch.where(cnt > 1, -2 - (((first + 1) << 4) | (cnt - 1)), POP)
        if any_hit:
            leaf_next = torch.where(hit_now, DONE, leaf_next)
        # ---- combine + pop ----
        nxt = torch.where(is_node, node_next, torch.where(is_leaf, leaf_next, DONE))
        want_pop = nxt == POP
        can_pop = want_pop & (sp > 0)
        sp = torch.where(can_pop, sp - 1, sp)
        popped = stack[lane, sp.clamp_max(stack_depth - 1).long()]
        cur = torch.where(want_pop, torch.where(can_pop, popped, DONE), nxt).to(torch.int32)
        it += 1
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)


def occluded(nodes, tris, tri_order, rays: Rays) -> Tensor:
    """Boolean shadow-ray query (reference `KernelDynamicScene::Occluded`)."""
    return intersect_bvh(nodes, tris, tri_order, rays, any_hit=True).valid


def intersect_bruteforce(tris: Tensor, rays: Rays, chunk: int = 512) -> Hit:
    """Reference O(B*T) intersector for testing the BVH path: every ray
    against every triangle, `chunk` triangles at a time."""
    T, B, dev = tris.shape[0], rays.o.shape[0], rays.o.device
    t_best = rays.tmax.clone()
    tri_best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(B, dtype=torch.float32, device=dev)
    v_best = torch.zeros(B, dtype=torch.float32, device=dev)
    bi = torch.arange(B, device=dev)
    for s0 in range(0, T, chunk):
        trow = tris[s0:s0 + chunk]
        valid, t, u, v = moller_trumbore(
            trow[None, :, 0:3], trow[None, :, 3:6], trow[None, :, 6:9],
            rays.o[:, None, :], rays.d[:, None, :], rays.tmin[:, None],
            t_best[:, None])
        t = torch.where(valid, t, torch.inf)
        j = torch.argmin(t, dim=1)
        tj = t[bi, j]
        better = tj < t_best
        t_best = torch.where(better, tj, t_best)
        tri_best = torch.where(better, (s0 + j).to(torch.int32), tri_best)
        u_best = torch.where(better, u[bi, j], u_best)
        v_best = torch.where(better, v[bi, j], v_best)
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)


def pack_tris(v0, v1, v2) -> np.ndarray:
    """Pack triangle vertices into the (T, 12) intersection layout."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    out = np.zeros((v0.shape[0], 12), np.float32)
    out[:, 0:3] = v0
    out[:, 3:6] = e1
    out[:, 6:9] = e2
    return out
