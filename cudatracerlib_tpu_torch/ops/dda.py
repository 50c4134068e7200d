"""Amanatides-Woo DDA grid traversal over the sort-based hash grid.

Port of ``cudatracerlib_tpu/ops/dda.py`` (the reference's grid walkers,
``Engine/SpatialStructures/Grid/SpatialGridTraversal.h:9-47``): every lane
walks its ray's pierced cells in lockstep; per-cell photon/beam rows are
fetched with the fixed-budget gathers of ops/hashgrid.py. Dead lanes idle
(masked). The walk stops once every lane is dead, as the JAX while_loop
does: each exit test reads one bool back from the device, counted in
``host_reads``, and ``iterations`` counts the steps walked.
"""
from __future__ import annotations

import torch

from . import hashgrid

Tensor = torch.Tensor

# exit tests read back from the device, and walk steps, so far
host_reads = 0
iterations = 0


def _any_alive(alive: Tensor) -> bool:
    global host_reads
    host_reads += 1
    return bool(alive.any())


def dda_walk(grid: hashgrid.HashGrid, o: Tensor, d: Tensor, t0: Tensor,
             t1: Tensor, visit_fn, init, max_cells: int = 64):
    """Walk the grid cells pierced by each ray segment [t0, t1].

    visit_fn(carry, flat_cell (B,), t_enter (B,), t_exit (B,), alive (B,))
    is called at most max_cells times, and no more once every lane is dead
    (dead lanes must contribute nothing). Returns the final carry.
    """
    global iterations
    cell_size = 1.0 / grid.inv_cell
    safe_d = torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    # clip the segment to the grid AABB; rays starting outside enter at t_lo
    grid_hi = grid.lo + grid.dims.to(torch.float32) * cell_size
    ta = (grid.lo - o) / safe_d
    tb = (grid_hi - o) / safe_d
    t_lo = torch.minimum(ta, tb).amax(-1)
    t_hi = torch.maximum(ta, tb).amin(-1)
    t0 = torch.maximum(t0, t_lo)
    t1 = torch.minimum(t1, t_hi)
    p0 = o + d * t0[:, None]
    dims = grid.dims
    cell = hashgrid.clip_cells(hashgrid.to_int32((p0 - grid.lo) * grid.inv_cell),
                               dims - 1)                       # (B, 3)
    step = torch.where(safe_d > 0, 1, -1).to(torch.int32)
    t_delta = (cell_size / safe_d).abs()                       # (B, 3)
    # parametric t of the next boundary crossing per axis
    next_b = grid.lo + (cell + torch.where(step > 0, 1, 0)).to(torch.float32) * cell_size
    t_max3 = t0[:, None] + (next_b - p0) / safe_d              # (B, 3)
    axes = torch.arange(3, dtype=torch.int64, device=o.device)

    carry, t_cur, alive = init, t0, t0 < t1
    it = 0
    while it < max_cells and _any_alive(alive):
        flat = hashgrid.flat_cell(cell, dims)
        t_next = t_max3.amin(-1)
        t_exit = torch.minimum(t_next, t1)
        carry = visit_fn(carry, flat, t_cur, t_exit, alive)
        oh = axes[None, :] == t_max3.argmin(-1)[:, None]
        cell = cell + torch.where(oh, step, 0)
        t_max3 = t_max3 + torch.where(oh, t_delta, 0.0)
        in_bounds = ((cell >= 0) & (cell < dims)).all(-1)
        alive = alive & (t_next < t1) & in_bounds
        t_cur = t_next
        it += 1
    iterations += it
    return carry


def gather_cell(grid: hashgrid.HashGrid, flat_cell: Tensor, accum_fn, carry,
                max_per_cell: int = 8):
    """accum_fn(carry, rows (B, K, W), mask (B, K)) called once with all K
    candidate rows of each lane's cell gathered."""
    start, count = hashgrid.query_ranges(grid, flat_cell)
    n = grid.data.shape[0]
    k = torch.arange(max_per_cell, dtype=torch.int32, device=flat_cell.device)
    idx = torch.clamp_max(start[:, None] + k[None, :], n - 1)
    rows = hashgrid._gather_rows(grid, idx)              # (B, K, W)
    return accum_fn(carry, rows, k[None, :] < count[:, None])


def build_ball_grid(data: Tensor, positions: Tensor, valid: Tensor, radius,
                    lo: Tensor, hi: Tensor, max_dim: int = 96) -> hashgrid.HashGrid:
    """Grid for beam-radiance estimates: each row is inserted into every cell
    its radius-r ball overlaps (the 2x2x2 block when cell >= 2r), so a ray
    only needs to visit its own pierced cells (reference BeamGrid.h
    photon-disc insertion). Duplicate cells within a block are dropped; at
    query time a row is accepted only when the visited cell contains the
    kernel foot point, which dedups rows shared by several cells. The
    sorted table gathers row order // 8 of `data` instead of repeating
    every row 8 times first."""
    N = data.shape[0]
    radius = torch.as_tensor(radius, dtype=torch.float32, device=data.device)
    extent = (hi - lo).clamp_min(1e-6)
    # grow the cell (never clamp dims) so the grid always covers the full
    # medium once the progressive radius shrinks below extent/max_dim
    cell_size = torch.maximum(2.0 * radius, extent.amax() / (max_dim - 1))
    dims = torch.ceil(extent / cell_size.clamp_min(1e-6)).to(torch.int32) + 1
    inv_cell = 1.0 / cell_size.clamp_min(1e-6)
    base = hashgrid.clip_cells(
        hashgrid.to_int32((positions - radius - lo) * inv_cell), dims - 2)
    c = hashgrid.clip_cells(base[:, None, :]
                            + hashgrid.offsets8(data.device)[None, :, :],
                            dims - 1)                                  # (N,8,3)
    cid = hashgrid.flat_cell(c, dims)                                  # (N,8)
    # drop duplicate cells within each row's block
    dup = torch.zeros((N, 8), dtype=torch.bool, device=data.device)
    for j in range(1, 8):
        for i in range(j):
            dup[:, j] |= cid[:, j] == cid[:, i]
    cid = torch.where(valid[:, None] & ~dup, cid, hashgrid.INT32_MAX)
    cid_flat = cid.reshape(-1)
    order = torch.argsort(cid_flat, stable=True)
    return hashgrid.HashGrid(data=data[order // 8], cell_ids=cid_flat[order],
                             lo=lo, inv_cell=inv_cell, dims=dims)
