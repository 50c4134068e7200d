"""Sort-based spatial hash grid for photon/beam storage.

Port of ``cudatracerlib_tpu/ops/hashgrid.py``: photons are hashed to
cells, sorted by cell id (a stable sort, as JAX's), and cell ranges are
recovered with binary searches. Queries gather the 8 cells of the
radius-aligned neighborhood with fixed per-cell photon budgets (masked).
The JAX grid's ``data_t``, a materialized transpose for the TPU's lane
gather, is kept as a field and left None: rows are gathered along axis 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm

Tensor = torch.Tensor

INT32_MAX = 2147483647
INT32_MIN = -2147483648
_OFFS8 = [[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)]


def to_int32(x: Tensor) -> Tensor:
    """float32 -> int32 as XLA converts: toward zero, saturating at the
    int32 range, NaN to 0 (``.to(torch.int32)`` leaves values out of range
    undefined: the CPU gives INT32_MIN for all of them). Rays that miss a
    grid reach cell coordinates near +-1e12."""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    y = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int32)
    y = torch.where(big, INT32_MAX, y)
    return torch.where(small, INT32_MIN, y)


_OFFS8_ON = {}   # device -> the offsets there, copied once


def offsets8(device) -> Tensor:
    """The 2x2x2 block's (8, 3) cell offsets, x fastest."""
    key = str(device)
    if key not in _OFFS8_ON:
        _OFFS8_ON[key] = torch.tensor(_OFFS8, dtype=torch.int32, device=device)
    return _OFFS8_ON[key]


def flat_cell(c: Tensor, dims: Tensor) -> Tensor:
    """Flat cell index of (..., 3) integer cell coordinates."""
    return (c[..., 2] * dims[1] + c[..., 1]) * dims[0] + c[..., 0]


def clip_cells(c: Tensor, hi: Tensor) -> Tensor:
    """jnp.clip(c, 0, hi) of int32 cell coordinates (hi (3,))."""
    return torch.minimum(c.clamp_min(0), hi)


class HashGrid(NamedTuple):
    data: Tensor        # (N, K) photon rows, sorted by cell id
    cell_ids: Tensor    # (N,) sorted cell id per row (invalid rows sort last)
    lo: Tensor          # (3,) grid origin
    inv_cell: Tensor    # () 1/cell_size
    dims: Tensor        # (3,) i32 grid resolution
    data_t: Tensor = None   # the JAX grid's TPU transpose; always None here


def cell_of(grid: HashGrid, p: Tensor) -> Tensor:
    """Flat cell index of world positions (clamped to the grid)."""
    c = to_int32((p - grid.lo) * grid.inv_cell)
    return flat_cell(clip_cells(c, grid.dims - 1), grid.dims)


def build_grid(data: Tensor, positions: Tensor, valid: Tensor, lo: Tensor,
               hi: Tensor, cell_size: Tensor, max_dim: int = 128) -> HashGrid:
    """Sort photon rows by grid cell. Invalid rows get cell INT32_MAX and
    sort last.

    data: (N, K) photon payload rows; positions: (N, 3); valid: (N,).
    """
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=data.device)
    extent = (hi - lo).clamp_min(1e-6)
    dims = (torch.ceil(extent / cell_size.clamp_min(1e-6)).to(torch.int32)
            + 1).clamp_max(max_dim)
    inv_cell = 1.0 / cell_size.clamp_min(1e-6)
    g = HashGrid(data=data, cell_ids=None, lo=lo, inv_cell=inv_cell, dims=dims)
    cid = torch.where(valid, cell_of(g, positions), INT32_MAX)
    order = torch.argsort(cid, stable=True)
    return HashGrid(data=data[order], cell_ids=cid[order], lo=lo,
                    inv_cell=inv_cell, dims=dims)


def query_ranges(grid: HashGrid, cells: Tensor):
    """(start, count) of the sorted rows for each query cell id (B,)."""
    start = torch.searchsorted(grid.cell_ids, cells, side="left")
    end = torch.searchsorted(grid.cell_ids, cells, side="right")
    return start.to(torch.int32), (end - start).to(torch.int32)


def neighbor_cells(grid: HashGrid, p: Tensor, radius: Tensor) -> Tensor:
    """The 8 cells covering a radius-r ball when cell_size >= 2r: offset the
    query by -r and take the 2x2x2 block. Returns (B, 8) cell ids."""
    base = to_int32((p - radius[..., None] - grid.lo) * grid.inv_cell)
    base = clip_cells(base, grid.dims - 2)
    c = base[:, None, :] + offsets8(p.device)[None, :, :]
    return flat_cell(clip_cells(c, grid.dims - 1), grid.dims)


def _gather_rows(grid: HashGrid, idx: Tensor) -> Tensor:
    """Fetch photon rows by index, shape-preserving: idx (...,) -> (..., W)."""
    return grid.data[idx.long()]


def gather_neighbors(grid: HashGrid, p: Tensor, radius: Tensor,
                     accum_fn, init, max_per_cell: int = 16):
    """Gather photons within `radius` of each query point.

    accum_fn(carry, rows (B, 8*K, W), mask (B, 8*K)) -> carry, called once
    with the whole 2x2x2 neighborhood gathered (positions in rows[..., 0:3])."""
    B = p.shape[0]
    cells = neighbor_cells(grid, p, radius)            # (B, 8)
    n = grid.data.shape[0]
    start, count = query_ranges(grid, cells.reshape(-1))
    start = start.reshape(B, 8)
    count = count.reshape(B, 8)
    k = torch.arange(max_per_cell, dtype=torch.int32, device=p.device)
    idx = torch.clamp_max(start[:, :, None] + k[None, None, :], n - 1)
    rows = _gather_rows(grid, idx.reshape(B, 8 * max_per_cell))
    in_rng = (k[None, None, :] < count[:, :, None]).reshape(B, -1)
    d2 = vm.length_sqr(rows[..., 0:3] - p[:, None, :])
    mask = in_rng & (d2 <= (radius * radius)[:, None])
    return accum_fn(init, rows, mask)
