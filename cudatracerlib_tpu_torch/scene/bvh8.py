"""8-wide BVH with 128-float "fat rows", collapsed from the binary BVH.

Verbatim port of ``cudatracerlib_tpu/scene/bvh8.py`` (host-side numpy):

  node row (128 f32):  child AABBs in SoA slices  lo_x[8] lo_y[8] lo_z[8]
                       hi_x[8] hi_y[8] hi_z[8]  (=48), child links (8 int32
                       bitcast) at [48:56], rest pad.
  leaf row (128 f32):  up to 12 triangles, SoA: v0x[12] v0y[12] v0z[12]
                       e1x e1y e1z e2x e2y e2z (=108), tri ids (12 int32
                       bitcast) at [108:120], count at [120].

Child links: link >= 0 -> internal node8 row, -1 -> empty slot,
link <= -2 -> leaf row -2 - link. One 512-byte row holds everything one
traversal step needs; ``csrc/traversal8.cu`` reads it as float4 loads.
``build_tlas8`` builds the same node rows over instance boxes (the TLAS of
``ops/instanced.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import bvh as bvh2mod

LEAF_TRIS = 12
WIDTH = 8


class BVH8(NamedTuple):
    nodes: np.ndarray    # (N8, 128) f32
    leaves: np.ndarray   # (L, 128) f32
    world_lo: np.ndarray
    world_hi: np.ndarray


def build_bvh8(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVH8:
    b2 = bvh2mod.build_bvh(v0, v1, v2, max_leaf=LEAF_TRIS)
    return collapse_bvh2(b2, v0, v1, v2)


def collapse_bvh2(b2: bvh2mod.BVH, v0, v1, v2) -> BVH8:
    nodes2 = b2.nodes
    links2 = np.stack([nodes2[:, 12].view(np.int32), nodes2[:, 13].view(np.int32)], 1)
    lo2 = np.stack([nodes2[:, 0:3], nodes2[:, 6:9]], 1)   # (N, 2, 3)
    hi2 = np.stack([nodes2[:, 3:6], nodes2[:, 9:12]], 1)
    order = b2.tri_order

    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)

    node_rows: list = []
    leaf_rows: list = []

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit_leaf(code: int) -> int:
        first, count = bvh2mod.decode_leaf(code)
        ids = order[first:first + count]
        row = np.zeros(128, np.float32)
        k = len(ids)
        row[0:k] = v0[ids, 0]; row[12:12 + k] = v0[ids, 1]; row[24:24 + k] = v0[ids, 2]
        row[36:36 + k] = e1[ids, 0]; row[48:48 + k] = e1[ids, 1]; row[60:60 + k] = e1[ids, 2]
        row[72:72 + k] = e2[ids, 0]; row[84:84 + k] = e2[ids, 1]; row[96:96 + k] = e2[ids, 2]
        idbits = np.full(12, -1, np.int32)
        idbits[:k] = ids
        row[108:120] = idbits.view(np.float32)
        row[120] = float(k)
        leaf_rows.append(row)
        return len(leaf_rows) - 1

    def emit_node(children) -> int:
        """children: list of (link2_code, lo, hi). Expand to <=8 slots by
        repeatedly splitting the largest-area internal child, then emit."""
        children = list(children)
        while len(children) < WIDTH:
            # pick internal child with the largest surface area
            best, best_a = -1, -1.0
            for i, (code, lo, hi) in enumerate(children):
                if code >= 0:
                    a = area(lo, hi)
                    if a > best_a:
                        best, best_a = i, a
            if best < 0:
                break
            code, lo, hi = children.pop(best)
            for slot in range(2):
                l = links2[code, slot]
                if l == bvh2mod.INVALID:
                    continue
                children.append((l, lo2[code, slot], hi2[code, slot]))
        row_idx = len(node_rows)
        node_rows.append(np.zeros(128, np.float32))
        links8 = np.full(WIDTH, -1, np.int32)
        row = node_rows[row_idx]
        for i, (code, lo, hi) in enumerate(children):
            row[0 + i] = lo[0]; row[8 + i] = lo[1]; row[16 + i] = lo[2]
            row[24 + i] = hi[0]; row[32 + i] = hi[1]; row[40 + i] = hi[2]
            if code >= 0:
                links8[i] = emit_node([
                    (links2[code, s], lo2[code, s], hi2[code, s])
                    for s in range(2) if links2[code, s] != bvh2mod.INVALID])
            else:
                links8[i] = -2 - emit_leaf(code)
        row[48:56] = links8.view(np.float32)
        return row_idx

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        root_children = [(links2[0, s], lo2[0, s], hi2[0, s])
                         for s in range(2) if links2[0, s] != bvh2mod.INVALID]
        emit_node(root_children)
    finally:
        sys.setrecursionlimit(old)

    return BVH8(nodes=np.stack(node_rows).astype(np.float32),
                leaves=np.stack(leaf_rows).astype(np.float32),
                world_lo=b2.world_lo, world_hi=b2.world_hi)


def build_tlas8(lo: np.ndarray, hi: np.ndarray, max_leaf: int = 2):
    """8-wide fat-row BVH over instance AABBs (the TLAS, reference
    ``Engine/SceneBVH.h:18`` rebuilt 8-wide).

    Node rows share the traversal layout (8 child AABBs + links) but leaf
    links keep the BINARY builder's leaf code -2-(first*16+count) into the
    returned instance `order` — the traversal expands them into per-lane
    instance visits (ops/instanced.tlas_visits) instead of testing
    triangles. Returns (table (R, 128), order (I,))."""
    b2 = bvh2mod.build_bvh(lo, hi, hi, max_leaf=max_leaf)
    nodes2 = b2.nodes
    links2 = np.stack([nodes2[:, 12].view(np.int32),
                       nodes2[:, 13].view(np.int32)], 1)
    lo2 = np.stack([nodes2[:, 0:3], nodes2[:, 6:9]], 1)
    hi2 = np.stack([nodes2[:, 3:6], nodes2[:, 9:12]], 1)
    rows: list = []

    def area(l, h):
        d = np.maximum(h - l, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit(children) -> int:
        children = list(children)
        while len(children) < WIDTH:
            best, best_a = -1, -1.0
            for i, (code, l, h) in enumerate(children):
                if code >= 0:
                    a = area(l, h)
                    if a > best_a:
                        best, best_a = i, a
            if best < 0:
                break
            code, l, h = children.pop(best)
            for s in range(2):
                ln = links2[code, s]
                if ln == bvh2mod.INVALID:
                    continue
                children.append((ln, lo2[code, s], hi2[code, s]))
        idx = len(rows)
        rows.append(np.zeros(128, np.float32))
        row = rows[idx]
        links8 = np.full(WIDTH, -1, np.int32)
        for i, (code, l, h) in enumerate(children):
            row[0 + i] = l[0]; row[8 + i] = l[1]; row[16 + i] = l[2]
            row[24 + i] = h[0]; row[32 + i] = h[1]; row[40 + i] = h[2]
            if code >= 0:
                links8[i] = emit([
                    (links2[code, s], lo2[code, s], hi2[code, s])
                    for s in range(2) if links2[code, s] != bvh2mod.INVALID])
            else:
                links8[i] = code            # keep the binary leaf code
        row[48:56] = links8.view(np.float32)
        return idx

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        emit([(links2[0, s], lo2[0, s], hi2[0, s])
              for s in range(2) if links2[0, s] != bvh2mod.INVALID])
    finally:
        sys.setrecursionlimit(old)
    return np.stack(rows).astype(np.float32), b2.tri_order
