"""Host-side binary BVH construction (numpy), collapsed into fat rows by bvh8.

Verbatim port of ``cudatracerlib_tpu/scene/bvh.py`` (binned SAH, 16 bins per
axis, object splits), so the port's tables are byte-identical to the JAX
build's.

Layout of the binary nodes:

  nodes: (N, 16) float32 rows =
     [lo0.xyz, hi0.xyz, lo1.xyz, hi1.xyz, link0, link1, pad, pad]
  links are int32 bitcast into the float slots:
     link >= 0           -> internal child node index
     link <= -2          -> leaf: code = -2 - (first * 16 + count),
                            first indexing into `tri_order`, count in [1, 15]
     link == -1 (INVALID)-> empty child
  tri_order: (T,) int32 permutation of triangle ids, leaf-contiguous.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

INVALID = -1
MAX_LEAF = 8
N_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


class BVH(NamedTuple):
    nodes: np.ndarray      # (N, 16) float32 packed as documented above
    tri_order: np.ndarray  # (T,) int32
    world_lo: np.ndarray   # (3,)
    world_hi: np.ndarray   # (3,)


def leaf_code(first: int, count: int) -> int:
    return -2 - (first * 16 + count)


def decode_leaf(code: int):
    v = -2 - code
    return v >> 4, v & 15


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf: int = MAX_LEAF) -> BVH:
    """Build a binary BVH over triangles given as three (T, 3) vertex arrays."""
    T = v0.shape[0]
    assert T > 0, "empty scene"
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = (0.5 * (lo + hi)).astype(np.float32)

    order = np.arange(T, dtype=np.int32)
    # Pre-allocate generously; binary tree over T leaves of >=1 tri
    max_nodes = max(2 * T, 16)
    nodes_lo = np.zeros((max_nodes, 2, 3), np.float32)
    nodes_hi = np.zeros((max_nodes, 2, 3), np.float32)
    links = np.full((max_nodes, 2), INVALID, np.int64)
    n_nodes = 1

    # Each stack entry: (node_idx, child_slot, start, end)  over `order`
    root_lo = lo.min(0)
    root_hi = hi.max(0)

    def sah_split(start: int, end: int):
        """Return (axis, bin_threshold_value, cost) or None for leaf."""
        ids = order[start:end]
        n = ids.shape[0]
        c = centroid[ids]
        cb_lo, cb_hi = c.min(0), c.max(0)
        ext = cb_hi - cb_lo
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            return None  # all centroids coincide
        # binned SAH on the widest axis
        scale = N_BINS * (1.0 - 1e-6) / ext[axis]
        bin_idx = ((c[:, axis] - cb_lo[axis]) * scale).astype(np.int32)
        # per-bin bounds via np.minimum.at
        blo = np.full((N_BINS, 3), np.inf, np.float32)
        bhi = np.full((N_BINS, 3), -np.inf, np.float32)
        cnt = np.zeros(N_BINS, np.int64)
        np.minimum.at(blo, bin_idx, lo[ids])
        np.maximum.at(bhi, bin_idx, hi[ids])
        np.add.at(cnt, bin_idx, 1)
        # prefix/suffix sweeps
        lft_lo = np.minimum.accumulate(blo, 0)
        lft_hi = np.maximum.accumulate(bhi, 0)
        rgt_lo = np.minimum.accumulate(blo[::-1], 0)[::-1]
        rgt_hi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = n - lcnt

        def area(alo, ahi):
            d = np.maximum(ahi - alo, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

        # split after bin i (i in [0, N_BINS-2])
        a_l = area(lft_lo[:-1], lft_hi[:-1])
        a_r = area(rgt_lo[1:], rgt_hi[1:])
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        cost = np.where(valid, a_l * lcnt[:-1] + a_r * rcnt[:-1], np.inf)
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            return None
        return axis, cb_lo[axis] + (best + 1) / scale, float(cost[best]), bin_idx, best

    # Iterative build. Root occupies a virtual slot: we store the root's two
    # children in node 0; handle the tiny-scene case by forcing a split or leaf.
    def make_node(start: int, end: int, depth: int) -> int:
        """Returns a link code for the range [start, end)."""
        nonlocal n_nodes
        n = end - start
        if n <= max_leaf:
            return leaf_code(start, n)
        res = sah_split(start, end)
        ids = order[start:end]
        if res is None:
            mid = start + n // 2  # median fallback
        else:
            axis, thresh, cost, bin_idx, best = res
            leaf_cost = INTERSECT_COST * n
            # note: SAH cost here is unnormalized; only used to pick the split
            go_left = bin_idx <= best
            nl = int(go_left.sum())
            if nl == 0 or nl == n:
                mid = start + n // 2
            else:
                order[start:end] = np.concatenate([ids[go_left], ids[~go_left]])
                mid = start + nl
        node = n_nodes
        n_nodes += 1
        for slot, (s, e) in enumerate(((start, mid), (mid, end))):
            child_ids = order[s:e]
            nodes_lo[node, slot] = lo[child_ids].min(0)
            nodes_hi[node, slot] = hi[child_ids].max(0)
            links[node, slot] = make_node(s, e, depth + 1)
        return node

    # Node 0 is the root: children of the full range
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(200000)
    try:
        if T <= max_leaf:
            nodes_lo[0, 0] = root_lo
            nodes_hi[0, 0] = root_hi
            links[0, 0] = leaf_code(0, T)
            nodes_lo[0, 1] = np.inf
            nodes_hi[0, 1] = -np.inf
            links[0, 1] = INVALID
        else:
            res = sah_split(0, T)
            ids = order[0:T]
            if res is None:
                mid = T // 2
            else:
                axis, thresh, cost, bin_idx, best = res
                go_left = bin_idx <= best
                nl = int(go_left.sum())
                if nl == 0 or nl == T:
                    mid = T // 2
                else:
                    order[0:T] = np.concatenate([ids[go_left], ids[~go_left]])
                    mid = nl
            for slot, (s, e) in enumerate(((0, mid), (mid, T))):
                child_ids = order[s:e]
                nodes_lo[0, slot] = lo[child_ids].min(0)
                nodes_hi[0, slot] = hi[child_ids].max(0)
                links[0, slot] = make_node(s, e, 1)
    finally:
        sys.setrecursionlimit(old_limit)

    return _pack(nodes_lo[:n_nodes], nodes_hi[:n_nodes], links[:n_nodes],
                 order, root_lo, root_hi)


def _pack(nodes_lo, nodes_hi, links, order, root_lo, root_hi) -> BVH:
    n = nodes_lo.shape[0]
    packed = np.zeros((n, 16), np.float32)
    packed[:, 0:3] = nodes_lo[:, 0]
    packed[:, 3:6] = nodes_hi[:, 0]
    packed[:, 6:9] = nodes_lo[:, 1]
    packed[:, 9:12] = nodes_hi[:, 1]
    packed[:, 12] = links[:, 0].astype(np.int32).view(np.float32)
    packed[:, 13] = links[:, 1].astype(np.int32).view(np.float32)
    return BVH(nodes=packed, tri_order=order.astype(np.int32),
               world_lo=root_lo.astype(np.float32), world_hi=root_hi.astype(np.float32))


def flatten_leaf_stats(bvh: BVH):
    """Debug: (num_nodes, num_leaves, avg_leaf_size)."""
    l0 = bvh.nodes[:, 12].view(np.int32)
    l1 = bvh.nodes[:, 13].view(np.int32)
    codes = np.concatenate([l0, l1])
    leaves = codes[codes <= -2]
    counts = (-2 - leaves) & 15
    return bvh.nodes.shape[0], leaves.shape[0], float(counts.mean()) if len(counts) else 0.0
