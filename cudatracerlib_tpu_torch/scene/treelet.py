"""Treelet decomposition of the unified fat-row BVH for large scenes.

Port of ``cudatracerlib_tpu/scene/treelet.py``: ``partition`` is the JAX
package's numpy code, verbatim, and its output is byte-identical. It splits
the unified table into a TOP table, whose cut edges become "virtual leaves"
naming a visit, and fixed-size treelet slabs that hold the cut subtrees.
``ops/traversal_tt.py`` traverses the two in two phases.

Link encoding in the unified table (scene/bvh8.py): >=0 node row; -1 empty;
<=-2 leaf row (-2 - link). In the TOP table, a leaf code whose row is at or
beyond the top table's row count is VIRTUAL: row - n_top is a visit id,
bit-packed as (treelet id << VID_ROOT_BITS) | local root row.

The port keeps both tables row-major, as K1's table is: the top table
(R_top, 128) and the slabs (n_treelets, treelet_rows, 128), with no padding,
no transpose and no inert pad slab, so the virtual-leaf threshold is the
top table's own row count. The JAX package's ``prep_device`` (transpose,
padding to 128 rows, virtual-link rebase) served the TPU's BlockSpec DMA and
is not carried over.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LANES = 128
TREELET_ROWS = 512       # rows per treelet slab (the JAX default)
MAX_TOP_ROWS = 2048      # the JAX MAX_SLABS * LANES: tables this small stay unsplit
VID_ROOT_BITS = 14       # visit id = (treelet id << VID_ROOT_BITS) | local root


class TreeletTable(NamedTuple):
    top: np.ndarray          # (R_top, 128) unified top table (nodes+leaves)
    slabs: np.ndarray        # (n_treelets, treelet_rows, 128) packed treelets
    n_treelets: int
    treelet_rows: int
    vid_map: np.ndarray      # (n_vids, 2) i32 (treelet id, local root), diagnostics
    root_top: "np.ndarray | None" = None   # top-local row of each forest root


def partition(table: np.ndarray, treelet_rows: int = TREELET_ROWS,
              max_top_rows: int = MAX_TOP_ROWS,
              roots: "tuple[int, ...]" = (0,)) -> "TreeletTable | None":
    """Partition a unified fat-row table into top + treelet slabs.

    Returns None when the table has at most max_top_rows rows (no treelets
    needed). Doubles treelet_rows until the top table fits max_top_rows.

    `roots` names the root node rows of a FOREST (disjoint row ranges);
    every root stays a top node and root_top maps roots[i] -> its top row.
    """
    R = table.shape[0]
    if R <= max_top_rows:
        return None
    treelet_rows = max(128, treelet_rows)   # kernel needs whole 128-row slabs
    # children lists per row (row indices into `table`; leaves have none)
    links = table[:, 48:56].view(np.float32).copy().view(np.int32).reshape(R, 8)
    is_node = np.zeros(R, bool)
    child_rows = {}
    # a row is a node iff some link points at it as >=0; we detect node rows
    # as those reachable via >=0 links from the forest roots and leaf rows as
    # those reachable via <=-2 links.
    # subtree sizes via iterative post-order from every root
    size = np.ones(R, np.int64)
    state = [(int(r), False) for r in roots]
    order = []
    seen_node = np.zeros(R, bool)
    while state:
        row, done = state.pop()
        if done:
            order.append(row)
            continue
        if seen_node[row]:
            continue
        seen_node[row] = True
        is_node[row] = True
        state.append((row, True))
        kids = []
        for l in links[row]:
            if l == -1:
                continue
            if l >= 0:
                kids.append(l)
                state.append((int(l), False))
            else:
                kids.append(-2 - l)   # leaf row
        child_rows[row] = kids
    for row in order:
        s = 1
        for c in child_rows.get(row, ()):  # leaf child contributes its row
            s += size[c] if is_node[c] else 1
        size[row] = s

    while True:
        # cut candidates: (subtree root row, rows, parent AABB of the subtree)
        cut_cands: list[tuple] = []
        top_nodes: list[int] = []
        stack = [int(r) for r in roots]
        while stack:
            row = stack.pop()
            top_nodes.append(row)
            r = table[row]
            for i in range(8):
                l = links[row][i]
                if l == -1 or l < 0:
                    continue  # leaf children of top nodes stay top leaves
                if size[l] <= treelet_rows:
                    lo = (float(r[0 + i]), float(r[8 + i]), float(r[16 + i]))
                    hi = (float(r[24 + i]), float(r[32 + i]), float(r[40 + i]))
                    cut_cands.append((int(l), int(size[l]), lo, hi))
                else:
                    stack.append(int(l))
        top_leaves: list[int] = []
        for row in top_nodes:
            for l in links[row]:
                if l <= -2:
                    top_leaves.append(-2 - l)
        if len(top_nodes) + len(top_leaves) <= max_top_rows:
            break
        treelet_rows *= 2

    # greedy first-fit-decreasing bin packing of cut subtrees into shared
    # slabs: without merging a big scene shatters into thousands of
    # mostly-empty slabs. Each subtree keeps its own root (per-visit root
    # rows), so a bin is a locality grouping with no constraint beyond
    # capacity.
    cut_cands.sort(key=lambda c: -c[1])
    bins: list[list] = []       # [rows_used, [cands]]
    for c in cut_cands:
        for b in bins:
            if b[0] + c[1] <= treelet_rows:
                b[0] += c[1]
                b[1].append(c)
                break
        else:
            bins.append([c[1], [c]])
    n_treelets = len(bins)

    # ---- pack treelet slabs (BFS per subtree, sequential within a bin) ----
    slabs = np.zeros((n_treelets, treelet_rows, 128), np.float32)
    vid_of_root: dict[int, int] = {}
    vid_tid: list[int] = []
    vid_root: list[int] = []
    assert treelet_rows <= (1 << VID_ROOT_BITS), treelet_rows
    assert n_treelets < (1 << (30 - VID_ROOT_BITS)), n_treelets
    for t, (_, cands) in enumerate(bins):
        local: dict[int, int] = {}
        for root, _, _, _ in cands:
            vid_of_root[root] = (t << VID_ROOT_BITS) | len(local)
            vid_tid.append(t)
            vid_root.append(len(local))
            bfs = [root]
            local[root] = len(local)
            qi = 0
            while qi < len(bfs):
                row = bfs[qi]
                qi += 1
                for l in links[row]:
                    if l == -1:
                        continue
                    c = int(l) if l >= 0 else -2 - int(l)
                    if c not in local:
                        local[c] = len(local)
                    if l >= 0:
                        bfs.append(int(l))
        assert len(local) <= treelet_rows, (len(local), treelet_rows)
        for r, i in local.items():
            slabs[t, i] = table[r]
        for r, i in local.items():
            if not is_node[r]:
                continue
            lk = slabs[t, i, 48:56].view(np.int32)
            for s in range(8):
                l = lk[s]
                if l == -1:
                    continue
                lk[s] = local[int(l)] if l >= 0 else -2 - local[-2 - int(l)]

    # ---- pack top table: nodes first, then leaves; cut links -> visit ids --
    top_nodes_sorted = sorted(top_nodes)
    node_local = {r: i for i, r in enumerate(top_nodes_sorted)}
    leaf_local: dict[int, int] = {}
    for r in top_leaves:
        if r not in leaf_local:
            leaf_local[r] = len(top_nodes_sorted) + len(leaf_local)
    n_top = len(top_nodes_sorted) + len(leaf_local)
    top = np.zeros((n_top, 128), np.float32)
    for r, i in leaf_local.items():
        top[i] = table[r]
    for r, i in node_local.items():
        top[i] = table[r]
        lk = top[i, 48:56].view(np.int32)
        for s in range(8):
            l = lk[s]
            if l == -1:
                continue
            if l >= 0:
                if l in vid_of_root:
                    lk[s] = -2 - (n_top + vid_of_root[l])   # virtual leaf
                else:
                    lk[s] = node_local[l]
            else:
                lk[s] = -2 - leaf_local[-2 - l]

    vid_map = np.stack([np.asarray(vid_tid, np.int32),
                        np.asarray(vid_root, np.int32)], axis=1)
    root_top = np.asarray([node_local[int(r)] for r in roots], np.int32)
    return TreeletTable(top=top, slabs=slabs, n_treelets=n_treelets,
                        treelet_rows=treelet_rows, vid_map=vid_map,
                        root_top=root_top)


def from_jax_layout(top_t: np.ndarray, slabs_t: np.ndarray):
    """Invert the JAX package's ``prep_device``: its (128, padded) transposed
    top table and (n_treelets + 1, 128, rows) transposed slabs (pad slab
    last) -> the port's (R_top, 128) top table and (n_treelets, rows, 128)
    slabs. The padding rows are all zero; virtual links that were rebased
    onto the padded row count go back onto R_top."""
    top = np.ascontiguousarray(top_t.T)
    padded = top.shape[0]
    nonzero = np.flatnonzero(top.view(np.uint32).any(axis=1))
    r = int(nonzero[-1]) + 1 if nonzero.size else 0
    top = top[:r].copy()
    for i in range(r):
        if top[i, 120] != 0.0:
            continue  # leaf row: [48:56] is triangle data, not links
        lk = top[i, 48:56].view(np.int32)
        for s in range(8):
            l = lk[s]
            if l <= -2 and (-2 - l) >= padded:
                lk[s] = -2 - (r + ((-2 - l) - padded))
    slabs = np.ascontiguousarray(slabs_t[:-1].transpose(0, 2, 1))
    return top, slabs


def unified_equivalent(tt: TreeletTable) -> np.ndarray:
    """A single unified table semantically identical to the partitioned one:
    virtual-leaf links become plain node links into the appended slab rows
    (the tests' check of the partition's remap round trip)."""
    n_top = tt.top.shape[0]
    out = np.concatenate([tt.top, tt.slabs.reshape(-1, 128)], axis=0).copy()
    for i in range(n_top):
        if out[i, 120] != 0.0:
            continue  # leaf row: [48:56] is e1y data, not links
        lk = out[i, 48:56].view(np.int32)
        for s_ in range(8):
            lnk = lk[s_]
            if lnk <= -2 and (-2 - lnk) >= n_top:
                vid = (-2 - lnk) - n_top
                tid, root = vid >> VID_ROOT_BITS, vid & ((1 << VID_ROOT_BITS) - 1)
                lk[s_] = n_top + tid * tt.treelet_rows + root  # node link
    for t in range(tt.slabs.shape[0]):
        base = n_top + t * tt.treelet_rows
        for rr in range(tt.treelet_rows):
            row = out[base + rr]
            lk = row[48:56].view(np.int32)
            # node rows have [120] == 0 (leaf rows keep their count there);
            # a padding row is all zero
            if row[120] != 0.0:
                continue
            if not np.any(lk != 0) and not np.any(row[:48] != 0):
                continue
            for s_ in range(8):
                lnk = lk[s_]
                if lnk == -1:
                    continue
                lk[s_] = (base + lnk) if lnk >= 0 else (-2 - (base + (-2 - lnk)))
    return out
