"""The game frame's path-space filter gather.

Each query (a primary hit) sums the cached direct light of the rows in its
2x2x2 cell neighbourhood (``hashgrid.neighbor_cells``, at most
MAX_PER_CELL rows a cell) that pass two hard tests: within the query's
radius (d^2 <= r^2) and a normal whose dot with the query's shading normal
is over 0.8. The rows are the game's cache rows, laid out by
``cache_rows`` (position, Li, normal, padding: 12 float32), which
csrc/psf_gather.cu reads as three float4.

``psf_gather`` takes the plain version, ``psf_gather_plain``, for CPU
tensors: ``hashgrid.gather_neighbors`` with the game's accumulation, bit
for bit the JAX package's. For CUDA tensors it launches
``csrc/psf_gather.cu``, which walks the same slots and makes the same
tests but never materialises the (B, 8 * MAX_PER_CELL, 12) neighbourhood;
only the order of its float32 sums differs. The grid build and the range
search (``hashgrid.query_ranges``) stay in PyTorch on both paths.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, hashgrid

Tensor = torch.Tensor

ROW_WIDTH = 12           # the game's cache row: position, Li, normal, padding
LI, NORMAL = slice(3, 6), slice(6, 9)
NORMAL_COS = 0.8         # the normal test: dot(row normal, query normal) > 0.8
MAX_PER_CELL = 16        # slots a cell (gather_neighbors' default; the kernel's kMaxPerCell)


def cache_rows(p: Tensor, Li: Tensor, ns: Tensor) -> Tensor:
    """(B, ROW_WIDTH) float32: the game's cache rows of B primary hits at
    p with direct light Li and shading normals ns (each (B, 3))."""
    return torch.cat([p, Li, ns, torch.zeros_like(p)], -1)


def neighbor_ranges(grid: hashgrid.HashGrid, p: Tensor, radius: Tensor):
    """(start, count), each (B, 8) int32: the sorted rows of the 8 cells
    around each query, as ``hashgrid.gather_neighbors`` finds them."""
    B = p.shape[0]
    cells = hashgrid.neighbor_cells(grid, p, radius)
    start, count = hashgrid.query_ranges(grid, cells.reshape(-1))
    return start.reshape(B, 8), count.reshape(B, 8)


def psf_gather_plain(grid: hashgrid.HashGrid, p: Tensor, ns: Tensor, radius: Tensor):
    """Plain version: the neighbourhood gathered whole, then the normal test
    and the sums over its (B, 8 * MAX_PER_CELL) slots."""
    B = p.shape[0]

    def accum(carry, prows, mask):
        acc, cnt = carry
        ok = mask & ((prows[..., NORMAL] * ns[:, None, :]).sum(-1) > NORMAL_COS)
        return (acc + torch.where(ok[..., None], prows[..., LI], 0.0).sum(1),
                cnt + ok.to(torch.float32).sum(1))

    init = (torch.zeros((B, 3), dtype=torch.float32, device=p.device),
            torch.zeros(B, dtype=torch.float32, device=p.device))
    return hashgrid.gather_neighbors(grid, p, radius, accum, init, MAX_PER_CELL)


def _lib():
    lib = cuda_build.load_library("psf_gather.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ctl_psf_gather.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp]
    lib.ctl_psf_gather.restype = ci
    return lib


def _check(x: Tensor, name: str, shape, device):
    if not isinstance(x, Tensor) or x.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}"
                         f"{'' if x.is_contiguous() else ', not contiguous'}")


def _p(x: Tensor):
    return ctypes.c_void_p(x.data_ptr())


def psf_gather(grid: hashgrid.HashGrid, p: Tensor, ns: Tensor, radius: Tensor):
    """(acc (B, 3), cnt (B,)) float32: for B queries at p (B, 3) with
    shading normals ns (B, 3) and radii radius (B,), the sum of Li over the
    rows of grid.data ((N, 12) float32) in the queries' neighbourhoods that
    pass both hard tests, and their number. Raises ValueError on inputs of
    another dtype, shape or device, or not contiguous; on CUDA tensors
    launches the kernel (one launch, counted in ``psf_gather.launches``)
    and raises RuntimeError if the card refuses it."""
    dev = p.device
    B = p.shape[0] if p.dim() == 2 else -1
    _check(p, "p", (B, 3), dev)
    _check(ns, "ns", (B, 3), dev)
    _check(radius, "radius", (B,), dev)
    N = grid.data.shape[0]
    _check(grid.data, "grid.data", (N, ROW_WIDTH), dev)
    if N == 0:
        raise ValueError("an empty grid")
    if dev.type == "cpu":
        return psf_gather_plain(grid, p, ns, radius)
    if dev.type != "cuda":
        raise ValueError(f"psf_gather runs on the CPU or a CUDA device, not {dev}")
    start, count = neighbor_ranges(grid, p, radius)
    return psf_gather_ranges(grid, start, count, p, ns, radius)


def psf_gather_ranges(grid: hashgrid.HashGrid, start: Tensor, count: Tensor, p: Tensor,
                      ns: Tensor, radius: Tensor):
    """The kernel's launch on CUDA tensors checked by ``psf_gather``, given
    the queries' ``neighbor_ranges`` (start, count: (B, 8) int32). Adds one
    to ``psf_gather.launches`` (none for no query)."""
    B, dev = p.shape[0], p.device
    for x, name in ((start, "start"), (count, "count")):
        if x.dtype != torch.int32 or tuple(x.shape) != (B, 8) or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"{name} must be a contiguous (B, 8) int32 tensor on {dev}")
    if grid.data.data_ptr() % 16:
        raise ValueError("grid.data must be 16-byte aligned")
    acc = torch.empty((B, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty(B, dtype=torch.float32, device=dev)
    err = _lib().ctl_psf_gather(
        _p(grid.data), grid.data.shape[0], _p(start), _p(count), _p(p), _p(ns),
        _p(radius), B, _p(acc), _p(cnt),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"psf_gather launch failed: error {err}")
    if B:    # no query, no launch
        _counter.launches += 1
    return acc, cnt


psf_gather.launches = 0
_counter = psf_gather    # counts on the wrapper itself, also while a recorder wraps it
