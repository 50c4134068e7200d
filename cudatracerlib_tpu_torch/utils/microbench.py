"""Microbenchmarks of the traversal kernels' building blocks on the card:
P1, P2 and P3 (``csrc/microbench.cu``).

They replace the JAX package's TPU microbenchmarks and Mosaic probes
(``tools/microbench_r2.py``, ``tools/microbench_r2c.py``,
``tools/probe_mosaic_pool.py``) and ask the questions that bound the
traversal kernels K1-K4 on Hopper:

- P1 ``chase_rows``: the latency of a dependent 512-byte row fetch, of
  the whole row or of the 14 float4 a traversal's node step reads
  (``NODE_WORDS``), in the ways the traversal kernels read a row
  (``CHASE_MODES``): one thread
  through L1/L2 ("thread"), from the block's shared memory ("shared"), 16
  lanes a row coalesced ("group", K1's group design), through a cluster's
  distributed shared memory ("cluster", K2's cluster design), and by a
  bulk copy into shared memory ("bulk", TMA); at two occupancies
  (``OCCUPANCIES``: 1,024 chains, and one chain a warp on every SM for the
  latency alone), each the slope of two step counts, so that the launch
  and the staging fall out. ``floor_entry`` picks the reading a
  traversal's chain floor takes (a node step's read from the nearest
  memory its rows can lie in, so that the floor is a lower bound);
- P2 ``gather_rows``: the throughput of independent 512-byte row gathers
  in K1's thread-per-row layout and a coalesced warp-per-row layout;
  ``gather_take``: ``table.index_select(0, idx)`` as the port gathers
  (``ops/hashgrid.gather_neighbors``' photon rows, ``ops/texture._take_rows``'
  texel quads), in three designs (``TAKE_DESIGNS``: a thread a row, a thread
  a float4, and TMA both ways), timed beside ``index_select`` and the
  port's own ``table[idx.long()]`` (``take_entries``); ``step_only``, a
  traversal step's slab or triangle tests on a row held in registers, at
  one warp an SM (a step's latency) and at full occupancy (``step_entries``;
  ``step_arith_ns`` is what the chain floors add to a row read); and
  ``loop_only``, the cost of a loop step by itself;
- P3 ``queue_fetch``: the cost of the warp queue's fetch in the three forms
  the kernels take (``QUEUE_FORMS``: a counter zeroed by a memset, the
  stream's work area, K4's claim at a threshold of idle lanes with dead
  items written at fetch), and that it hands out every item exactly once
  (``queue_entries``).

Each kernel wrapper (``*_cuda``, with a ``launches`` counter) takes CUDA
tensors only and has a plain PyTorch version beside it (the name without
``_cuda``), which the CPU tests hold to numpy loops and ``chip_smoke.py``
holds the kernel to. ``measure`` times them on the card and holds each
output to its plain version's on the same inputs.

A row's value is the xor of its 128 32-bit words; after step s a chain
goes to row ((that xor + s * 0x9E3779B9) mod 2^32) mod the row count, so
it does not close into a short cycle of cached rows.
"""
from __future__ import annotations

import ctypes
import statistics

import torch

from ..ops import cuda_build, traversal8
from ..ops.traversal import Rays, _safe_inv
from .schedule_probe import slab_variant

Tensor = torch.Tensor

ROW_BYTES = 512
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
PEAK_FLOPS_F32 = 67e12        # H100 SXM float32 outside the tensor cores
# the TPU microbenchmarks' table sizes, then Cornell's, veach-mis's, the
# 4.8M-triangle San Miguel stand-in's top table and the 1.2M-triangle
# stand-in's whole table (108 MB, past the 50 MB L2)
TABLE_ROWS = (256, 1024, 4096, 317, 331, 998, 211592)
CHAINS, CHAIN_STEPS = 1024, 256        # P1's B and steps (and twice them)
# float4 a P1 step reads from the start of its row: the whole row, or what
# a traversal's node step reads (its boxes and links: the cheaper step
# kind, so a floor from it stays a lower bound)
ROW_WORDS, NODE_WORDS = 32, 14
# P1's modes (the C entry's codes) and the (mode, param, words) runs
# measure() times: G = 16 lanes a chain (K1's group design), clusters of
# 2, 4 and 8 blocks (K2's cluster design takes 2, 4 or 8); the whole row in
# every mode, a node step's read in the modes a chain floor takes
CHASE_MODES = {"thread": 0, "shared": 1, "group": 2, "cluster": 3, "bulk": 4}
GROUP_LANES = (8, 16, 32)
CLUSTER_BLOCKS = (1, 2, 4, 8)
_FLOOR_RUNS = (("thread", None), ("shared", None), ("group", 16), ("cluster", 2),
               ("cluster", 4), ("cluster", 8))
CHASE_RUNS = (tuple((m, p, ROW_WORDS) for m, p in _FLOOR_RUNS + (("bulk", None),))
              + tuple((m, p, NODE_WORDS) for m, p in _FLOOR_RUNS))
CHASE_THREADS = 128                    # a block's threads (the kernels' cap)
# the two occupancies: "chains" runs CHAINS chains in blocks of
# CHASE_THREADS, the kernel table's row shape; "warp" one chain a warp, one
# warp a block, a block for every SM: the latency alone
OCCUPANCIES = ("chains", "warp")
# the P1 reading a traversal design's rows are held to (its chain floor):
# the mode whose read the design makes, and its parameter (None: any); the
# split design's staged rows (``split_floor`` holds the rest to "thread")
DESIGN_READS = {"thread": ("thread", None), "group": ("group", 16),
                "shared": ("shared", None), "cluster": ("cluster", None),
                "global": ("thread", None), "split": ("shared", None)}
GATHERS = 1 << 20                      # P2's independent gathers per launch
LOOP_LANES, LOOP_STEPS = 1024, 65536
QUEUE_ITEMS = (65536, 131072, 262144)  # the path's merged wavefront sizes
LOOP_FACTOR = 1.000001
CHAIN_MIX = 0x9E3779B9
# P2 (a): gather_take's designs (the C entry's codes); the row width (in
# float32) they take, the port's gathers' (the hash grid's photon rows and
# the texel quads: 48 bytes)
TAKE_DESIGNS = {"thread": 0, "flat": 1, "bulk": 2}
TAKE_WIDTH = 12
# the hash grid's neighbourhood: 8 runs of 16 rows a query
# (ops/hashgrid.gather_neighbors' max_per_cell)
RUNS, RUN_ROWS = 8, 16
# P2 (b): the steps step_only times (and twice them: ns per step the
# slope); its kinds (row, any-hit); the occupancies (one warp a block, a
# block an SM: a step's latency; every SM full: the issue rate); float32
# operations of a leaf step (about 54 a triangle for 12), beside
# traversal8.NODE_STEP_FLOPS
STEP_ITERS = 256
STEP_KINDS = (("node", False), ("node", True), ("leaf", False), ("leaf", True))
STEP_OCCUPANCIES = ("warp", "full")
LEAF_STEP_FLOPS = 54 * 12
# P3's forms (the C entry's codes) and occupancies
QUEUE_FORMS = {"memset": 0, "work": 1, "threshold": 2}
QUEUE_OCCUPANCIES = ("full", "warp")
# the configuration of each kernel's row in chip_smoke.py's kernel table:
# veach-mis's table, and its merged wavefront (two chunks of 65,536 lanes)
ROW_TABLE_ROWS, ROW_QUEUE_ITEMS = 331, 131072


def bound_ms(n_bytes: float, n_ops: float):
    """(least milliseconds the card could take, "bytes" or "operations"):
    the larger of the bytes over the device memory rate and the float32
    operations over the peak float32 rate (published H100 SXM peaks)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- plain versions

def _row_xor(rows: Tensor) -> Tensor:
    """(N, W) float32 rows -> (N,) int64 xor of each row's 32-bit words,
    as an unsigned value."""
    w = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    width = 1 << (w.shape[1] - 1).bit_length()
    w = torch.nn.functional.pad(w, (0, width - w.shape[1]))   # xor with 0
    while w.shape[1] > 1:
        half = w.shape[1] // 2
        w = w[:, :half] ^ w[:, half:]
    return w[:, 0]


def _as_int32(u: Tensor) -> Tensor:
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def chase_rows(table: Tensor, idx0: Tensor, n_steps: int,
               seen: Tensor = None, words: int = ROW_WORDS) -> Tensor:
    """P1's plain version: (C,) int32 last row of each chain, each step
    reading the first `words` float4 of its row. Every mode computes it.
    `seen`, a (rows,) bool tensor, marks each row a chain reads."""
    n_rows = table.shape[0]
    idx = idx0.to(torch.int64)
    for s in range(n_steps):
        if seen is not None:
            seen[idx] = True
        idx = ((_row_xor(table[idx, :4 * words]) + s * CHAIN_MIX) & 0xFFFFFFFF) \
            % n_rows
    return idx.to(torch.int32)


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """P2's plain version: (N,) int32 xor of row idx[i]'s words."""
    return _as_int32(_row_xor(table[idx.to(torch.int64)]))


def loop_only(x0: Tensor, n_steps: int) -> Tensor:
    """P2's empty loop: x = x * 1.000001 + 1, n_steps times (float32)."""
    x = x0.clone()
    for _ in range(n_steps):
        x = x * LOOP_FACTOR + 1.0
    return x


def queue_fetch(n: int, n_warps: int = 4, device="cpu") -> Tensor:
    """P3's plain version: the warp queue played in rounds, every warp in
    turn claiming one item for each of its 32 lanes from the shared counter
    until a claim reaches past the queue. Returns (n,) int32 counts of how
    often each item was handed out."""
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    lanes = torch.arange(32 * n_warps, device=device)
    counter = 0
    while counter < n:
        ids = counter + lanes
        counts.index_add_(0, ids[ids < n], torch.ones_like(ids[ids < n],
                                                           dtype=torch.int32))
        counter += 32 * n_warps
    return counts


def queue_threshold(steps: Tensor, tmin: Tensor, tmax: Tensor):
    """P3's threshold form's plain version: (counts, out) of a queue of
    items with these steps, tmin and tmax: every count 1; out = tmax for a
    dead item (!(tmin <= tmax)), written at fetch, else tmin + steps."""
    counts = torch.ones(steps.shape[0], dtype=torch.int32, device=steps.device)
    return counts, torch.where(~(tmin <= tmax), tmax, tmin + steps.to(torch.float32))


def gather_take(table: Tensor, idx: Tensor) -> Tensor:
    """P2 (a)'s plain version, the port's own gather (``ops/hashgrid``,
    ``ops/texture``): the rows idx of table, copied."""
    return table[idx.long()]


def run_index(starts: Tensor, n_rows: int, run: int = RUN_ROWS) -> Tensor:
    """The index stream of runs of `run` consecutive rows from each of
    `starts` ((Q, k) int32), each clamped to the last row, as
    ``ops/hashgrid.gather_neighbors`` builds it: (Q * k * run,) int32."""
    k = torch.arange(run, dtype=torch.int32, device=starts.device)
    return torch.clamp_max(starts[..., None] + k, n_rows - 1).reshape(-1)


def _node_step(row: Tensor, o: Tensor, inv: Tensor, tmn: Tensor, tb: Tensor):
    """One node step from the root state, every child unvisited, on an
    empty walk, in ops/traversal8._lockstep's float order: the next state
    xor the entry t's bits, (B,) int32."""
    B, dev = o.shape[0], o.device
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    ix, iy, iz = (inv[:, k:k + 1] for k in range(3))
    t0x, t1x = (row[None, 0:8] - ox) * ix, (row[None, 24:32] - ox) * ix
    t0y, t1y = (row[None, 8:16] - oy) * iy, (row[None, 32:40] - oy) * iy
    t0z, t1z = (row[None, 16:24] - oz) * iz, (row[None, 40:48] - oz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), tmn))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), tb))
    links = row[48:56].view(torch.int32)
    t_sel = torch.where((tn <= tf) & (links[None, :] != traversal8.DONE), tn,
                        float("inf"))
    best_t = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    best_j = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(8):
        closer = t_sel[:, j] < best_t
        best_t = torch.where(closer, t_sel[:, j], best_t)
        best_j = torch.where(closer, j, best_j)
    has = best_t < float("inf")
    link = links[best_j]
    nxt = torch.where(has, torch.where(link >= 0, (link << 8) | 0xFF, link),
                      traversal8.DONE)
    tent = torch.where(has, best_t, 0.0)
    return nxt ^ tent.view(torch.int32)


def _leaf_step(row: Tensor, o: Tensor, d: Tensor, tmn: Tensor, tb: Tensor):
    """One leaf step with the best hit at tmax, in _lockstep's float
    order: the best hit's t, triangle, u and v bits xored, (B,) int32."""
    B, dev = o.shape[0], o.device
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = row[None, 0:12], row[None, 12:24], row[None, 24:36]
    e1x, e1y, e1z = row[None, 36:48], row[None, 48:60], row[None, 60:72]
    e2x, e2y, e2z = row[None, 72:84], row[None, 84:96], row[None, 96:108]
    ids = row[108:120].view(torch.int32)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((ids[None, :] != -1) & (det.abs() >= 1e-12) & (u >= 0) & (v >= 0)
          & (u + v <= 1.0) & (t > tmn) & (t < tb))
    t_tri = torch.where(ok, t, float("inf"))
    t_hit = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    k_hit = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(12):
        closer = t_tri[:, k] < t_hit
        t_hit = torch.where(closer, t_tri[:, k], t_hit)
        k_hit = torch.where(closer, k, k_hit)
    hit = t_hit < float("inf")
    lanes = torch.arange(B, device=dev)
    bt = torch.where(hit, t_hit, tb[:, 0])
    tri = torch.where(hit, ids[k_hit], -1)
    bu = torch.where(hit, u[lanes, k_hit], 0.0)
    bv = torch.where(hit, v[lanes, k_hit], 0.0)
    return bt.view(torch.int32) ^ tri ^ bu.view(torch.int32) ^ bv.view(torch.int32)


def step_only(rows: Tensor, rays: Rays, n_steps: int, node: bool,
              any_hit: bool = False):
    """P2 (b)'s plain version: each lane's ray takes `n_steps` steps on one
    row of `rows` ((2, 128): the node row, the leaf row), each from the
    same state (node: the root state, every child unvisited; leaf: the best
    hit at tmax) on an empty walk, in ops/traversal8._lockstep's float
    order; after each step the lowest bit of its result (node: the next
    state xor the entry t's bits; leaf: the best hit's t, triangle, u and v
    bits xored) flips the lowest bit of the ray's origin and direction
    components, while the inverse direction stays the first one's. A leaf
    step's result does not depend on `any_hit` (its walk ends either way).
    Returns ((B, 6) float32 last origins and directions, (B,) int32 xor of
    the results)."""
    o, d = rays.o.contiguous(), rays.d.contiguous()
    inv = _safe_inv(d)
    tmn, tb = rays.tmin[:, None], rays.tmax[:, None]
    row = rows[0 if node else 1]
    acc = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for _ in range(n_steps):
        res = _node_step(row, o, inv, tmn, tb) if node else _leaf_step(row, o, d, tmn, tb)
        acc = acc ^ res
        h = (res & 1)[:, None]
        o = (o.view(torch.int32) ^ h).view(torch.float32)
        d = (d.view(torch.int32) ^ h).view(torch.float32)
    return torch.cat([o, d], 1), acc


# --------------------------------------------------------------- kernel wrappers

def _lib():
    lib = cuda_build.load_library("microbench.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ctl_chase_rows.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp]
    lib.ctl_gather_rows.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.ctl_loop_only.argtypes = [vp, ci, ci, vp, vp]
    lib.ctl_gather_take.argtypes = [vp, ci, ci, vp, ctypes.c_longlong, ci, vp, vp]
    lib.ctl_step_only.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.ctl_step_only_blocks.argtypes = [ci, ci]
    lib.ctl_queue_fetch.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.ctl_queue_blocks.argtypes = [ci]
    for fn in (lib.ctl_chase_rows, lib.ctl_gather_rows, lib.ctl_loop_only,
               lib.ctl_gather_take, lib.ctl_step_only, lib.ctl_step_only_blocks,
               lib.ctl_queue_fetch, lib.ctl_queue_blocks):
        fn.restype = ci
    return lib


def _check(x: Tensor, name: str, dtype, shape):
    if not (isinstance(x, Tensor) and x.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err}")


def _p(x: Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _check_table(table: Tensor):
    _check(table, "table", torch.float32, (table.shape[0], 128))
    if table.shape[0] == 0 or table.data_ptr() % 16:
        raise ValueError("table must be non-empty and 16-byte aligned")


def check_chase(mode: str, param, lanes: int, threads: int, n_rows: int,
                shared_limit: int, words: int = ROW_WORDS):
    """(param, lanes) of a P1 launch in `mode` (``CHASE_MODES``) on a table
    of `n_rows` rows, the defaults filled in (group: G = 16 lanes a chain;
    cluster: the fewest blocks whose shares fit, ``schedule_probe.slab_variant``;
    lanes: G for group, else 1), on a card whose blocks may opt in to
    `shared_limit` bytes of shared memory. Raises ValueError, as the C
    entry refuses: another mode, G or blocks count; lanes not a power of
    two up to 32 or under G; threads not a multiple of 32 up to
    CHASE_THREADS; words other than ROW_WORDS and NODE_WORDS; a table
    (shared) or a block's share of it (cluster) that does not fit a
    block."""
    if words not in (ROW_WORDS, NODE_WORDS):
        raise ValueError(f"a P1 step reads {ROW_WORDS} or {NODE_WORDS} float4, "
                         f"not {words}")
    if mode not in CHASE_MODES:
        raise ValueError(f"no P1 mode {mode!r}: one of {list(CHASE_MODES)}")
    if mode == "group":
        param = 16 if param is None else param
        if param not in GROUP_LANES:
            raise ValueError(f"a group reads a row with {GROUP_LANES} lanes, not {param}")
    elif mode == "cluster":
        param = slab_variant(n_rows, shared_limit) if param is None else param
        if param not in CLUSTER_BLOCKS:
            raise ValueError(f"no cluster of {CLUSTER_BLOCKS} blocks holds {n_rows} rows"
                             if param == 0 else
                             f"a cluster has {CLUSTER_BLOCKS} blocks, not {param}")
    else:
        param = 0
    lanes = (param if mode == "group" else 1) if lanes is None else lanes
    if not (1 <= lanes <= 32 and lanes & (lanes - 1) == 0) \
            or (mode == "group" and lanes < param):
        raise ValueError(f"{lanes} lanes a chain: a power of two up to 32, "
                         f"at least the group's {param}")
    if threads % 32 or not 32 <= threads <= CHASE_THREADS:
        raise ValueError(f"{threads} threads a block: a multiple of 32 up to "
                         f"{CHASE_THREADS}")
    share = -(-n_rows // (param if mode == "cluster" else 1)) * ROW_BYTES
    if mode in ("shared", "cluster") and share > shared_limit:
        raise ValueError(f"{n_rows} rows do not fit shared memory in mode {mode}"
                         + (f" over {param} blocks" if mode == "cluster" else ""))
    return param, lanes


def chase_rows_cuda(table: Tensor, idx0: Tensor, n_steps: int,
                    mode: str = "thread", param: int = None, lanes: int = None,
                    threads: int = CHASE_THREADS, words: int = ROW_WORDS) -> Tensor:
    """P1 on the card in `mode` with `param`, `lanes` threads a chain,
    blocks of `threads` and `words` float4 read a step (``check_chase``,
    which fills the defaults and raises on what the kernel does not take;
    ``chase_rows`` with the same `words` is its plain version). Each
    launch adds one to
    ``chase_rows_cuda.launches`` and to
    ``chase_rows_cuda.launches_by_mode[mode]``."""
    _check_table(table)
    _check(idx0, "idx0", torch.int32, (idx0.shape[0],))
    param, lanes = check_chase(mode, param, lanes, threads, table.shape[0],
                               traversal8._shared_limit(table.device.index), words)
    out = torch.empty_like(idx0)
    _raise_on(_lib().ctl_chase_rows(_p(table), table.shape[0], _p(idx0),
                                    idx0.shape[0], n_steps, CHASE_MODES[mode],
                                    param, lanes, threads, words, _p(out),
                                    _stream(table.device)),
              "chase_rows")
    chase_rows_cuda.launches += 1
    chase_rows_cuda.launches_by_mode[mode] += 1
    return out


chase_rows_cuda.launches = 0
chase_rows_cuda.launches_by_mode = dict.fromkeys(CHASE_MODES, 0)


def gather_rows_cuda(table: Tensor, idx: Tensor, warp: bool = False) -> Tensor:
    """P2's row gather on the card: thread-per-row, or with `warp`
    warp-per-row."""
    _check_table(table)
    _check(idx, "idx", torch.int32, (idx.shape[0],))
    out = torch.empty_like(idx)
    _raise_on(_lib().ctl_gather_rows(_p(table), _p(idx), idx.shape[0],
                                     int(warp), _p(out), _stream(table.device)),
              "gather_rows")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def loop_only_cuda(x0: Tensor, n_steps: int) -> Tensor:
    _check(x0, "x0", torch.float32, (x0.shape[0],))
    out = torch.empty_like(x0)
    _raise_on(_lib().ctl_loop_only(_p(x0), x0.shape[0], n_steps, _p(out),
                                   _stream(x0.device)), "loop_only")
    loop_only_cuda.launches += 1
    return out


loop_only_cuda.launches = 0


def gather_take_cuda(table: Tensor, idx: Tensor, design: str = "flat") -> Tensor:
    """P2 (a) on the card in `design` (``TAKE_DESIGNS``): the rows idx of
    table ((R, TAKE_WIDTH) float32), as
    ``table.index_select(0, idx)``; ``gather_take``
    is its plain version. idx is (N,) int32, 16-byte aligned, every index
    in [0, R) (not checked: a kernel reads what it is given). Raises on
    anything else and when the card refuses the launch. Each launch (none
    for an empty index) adds one to ``gather_take_cuda.launches`` and to
    ``gather_take_cuda.launches_by_design[design]``."""
    if design not in TAKE_DESIGNS:
        raise ValueError(f"no gather design {design!r}: one of {list(TAKE_DESIGNS)}")
    W = table.shape[1] if table.dim() == 2 else 0
    _check(table, "table", torch.float32, (table.shape[0], W))
    _check(idx, "idx", torch.int32, (idx.shape[0],))
    if W != TAKE_WIDTH or table.shape[0] == 0:
        raise ValueError(f"gather_take takes rows of {TAKE_WIDTH} float32, not {W}")
    if table.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("table and idx must be 16-byte aligned")
    out = torch.empty((idx.shape[0], W), dtype=torch.float32, device=table.device)
    _raise_on(_lib().ctl_gather_take(_p(table), table.shape[0], W // 4, _p(idx),
                                     idx.shape[0], TAKE_DESIGNS[design], _p(out),
                                     _stream(table.device)), "gather_take")
    if idx.shape[0]:     # no index, no launch
        gather_take_cuda.launches += 1
        gather_take_cuda.launches_by_design[design] += 1
    return out


gather_take_cuda.launches = 0
gather_take_cuda.launches_by_design = dict.fromkeys(TAKE_DESIGNS, 0)


def step_only_cuda(rows: Tensor, rays: Rays, n_steps: int, node: bool,
                   any_hit: bool = False, threads: int = CHASE_THREADS):
    """P2 (b) on the card (``step_only`` is its plain version, with the same
    arguments and outputs), in blocks of `threads` (32: one warp a block,
    or CHASE_THREADS). rows: (2, 128) float32; rays' o, d (B, 3) and tmin,
    tmax (B,) float32. Each launch adds one to ``step_only_cuda.launches``
    and to ``step_only_cuda.launches_by_kind["node"|"leaf"]``."""
    _check(rows, "rows", torch.float32, (2, 128))
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    B = rays.o.shape[0]
    for x, name, shape in ((rays.o, "rays.o", (B, 3)), (rays.d, "rays.d", (B, 3)),
                           (rays.tmin, "rays.tmin", (B,)), (rays.tmax, "rays.tmax", (B,))):
        _check(x, name, torch.float32, shape)
    if threads not in (32, CHASE_THREADS):
        raise ValueError(f"{threads} threads a block: 32 or {CHASE_THREADS}")
    od = torch.empty((B, 6), dtype=torch.float32, device=rows.device)
    acc = torch.empty(B, dtype=torch.int32, device=rows.device)
    _raise_on(_lib().ctl_step_only(_p(rows), _p(rays.o), _p(rays.d), _p(rays.tmin),
                                   _p(rays.tmax), B, n_steps, int(bool(node)),
                                   int(bool(any_hit)), threads, _p(od), _p(acc),
                                   _stream(rows.device)), "step_only")
    if B:
        step_only_cuda.launches += 1
        step_only_cuda.launches_by_kind["node" if node else "leaf"] += 1
    return od, acc


step_only_cuda.launches = 0
step_only_cuda.launches_by_kind = dict(node=0, leaf=0)


def step_only_blocks(node: bool, any_hit: bool) -> int:
    """The CHASE_THREADS-thread blocks of step_only's kernel one SM holds
    at once (builds the library)."""
    return _lib().ctl_step_only_blocks(int(bool(node)), int(bool(any_hit)))


def queue_blocks(form: str) -> int:
    """The CHASE_THREADS-thread blocks of P3's kernel in `form` one SM
    holds at once (builds the library)."""
    return _lib().ctl_queue_blocks(QUEUE_FORMS[form])


def queue_warps(form: str, n: int, occupancy: str, sms: int) -> int:
    """The warps of a P3 launch of n items: one a block and a block an SM
    ("warp"), or the blocks that fill every SM ("full"); no more than the
    items need."""
    if occupancy == "warp":
        return min(sms, -(-n // 32))
    return min(queue_blocks(form) * sms, -(-n // CHASE_THREADS)) * (CHASE_THREADS // 32)


def queue_fetch_cuda(n: int, device="cuda", form: str = "memset",
                     occupancy: str = "full", items=None):
    """P3 on the card: a queue of n items drained in `form`
    (``QUEUE_FORMS``) at `occupancy` (``QUEUE_OCCUPANCIES``). Returns
    (counts (n,) int32, each 1 when the queue is right; out (n,) float32,
    the threshold form's payload, else None; the claims, a (1,) int64
    tensor: the counter's end over 32 for the forms where every lane asks,
    the kernel's own count for the threshold form; the threshold form's
    (3,) int64 stats: claims, cycles in fetch rounds, cycles in all, summed
    over warps, else None). The work-area and threshold forms count in the
    stream's work area (``traversal8.stream_group_work``), which a refused
    launch drops (``traversal8.forget_stream_work``); the threshold form
    takes items = (steps (n,) int32, tmin, tmax (n,) float32). Each
    launch adds one to ``queue_fetch_cuda.launches`` and to
    ``queue_fetch_cuda.launches_by_form[form]``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("queue_fetch_cuda runs on a CUDA device")
    if form not in QUEUE_FORMS or occupancy not in QUEUE_OCCUPANCIES:
        raise ValueError(f"no P3 form {form!r} or occupancy {occupancy!r}: "
                         f"{list(QUEUE_FORMS)}, {list(QUEUE_OCCUPANCIES)}")
    if (items is None) != (form != "threshold"):
        raise ValueError("the threshold form takes items = (steps, tmin, tmax), "
                         "the others none")
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    out = stats = None
    ptrs = [None] * 3
    if items is not None:
        steps, tmin, tmax = items
        for x, name, dt in ((steps, "steps", torch.int32), (tmin, "tmin", torch.float32),
                            (tmax, "tmax", torch.float32)):
            _check(x, name, dt, (n,))
        ptrs = [_p(x) for x in items]
        out = torch.empty(n, dtype=torch.float32, device=device)
        stats = torch.zeros(3, dtype=torch.int64, device=device)
    if form == "memset":
        counter, count_set = torch.empty(1, dtype=torch.int32, device=device), 0
    else:
        counter, count_set = traversal8.stream_group_work(n, device, queue=False)
    err = _lib().ctl_queue_fetch(QUEUE_FORMS[form], n, _p(counter), count_set, *ptrs,
                                 _p(counts), out if out is None else _p(out),
                                 stats if stats is None else _p(stats),
                                 int(occupancy == "warp"), _stream(device))
    if err != 0 and form != "memset":
        traversal8.forget_stream_work(device)
    _raise_on(err, "queue_fetch")
    if form == "threshold":
        claims = stats[:1]
    else:
        base = count_set * traversal8.GROUP_WORK // 2
        claims = counter[base:base + 1].to(torch.int64) // 32
    if n:
        queue_fetch_cuda.launches += 1
        queue_fetch_cuda.launches_by_form[form] += 1
    return counts, out, claims, stats


queue_fetch_cuda.launches = 0
queue_fetch_cuda.launches_by_form = dict.fromkeys(QUEUE_FORMS, 0)
KERNELS = (chase_rows_cuda, gather_rows_cuda, loop_only_cuda, gather_take_cuda,
           step_only_cuda, queue_fetch_cuda)


# --------------------------------------------------------------- on the card

# a sleeping kernel queued before a timed run: ~5 ms on an H100, longer
# than the host takes to queue the run's calls
SLEEP_CYCLES = 10_000_000


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of `fn` on the current stream: CUDA events
    around `reps` calls after `warmup` calls, all queued behind a sleeping
    kernel, so that a call shorter than its host-side launch is timed on
    the device and not at the host's pace (a call that waits for the
    device still waits)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _random_table(n_rows: int, gen: torch.Generator, dev) -> Tensor:
    """Random 32-bit words viewed as float32 (only their bits are used)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, 128), generator=gen,
                         dtype=torch.int32, device=dev).view(torch.float32)


def _random_idx(n: int, n_rows: int, gen: torch.Generator, dev) -> Tensor:
    return torch.randint(0, n_rows, (n,), generator=gen, dtype=torch.int32,
                         device=dev)


def _timed(fn, reps: int = 10):
    """(ms per call of `fn`, by event_ms; the output of its last call)."""
    out = [None]

    def call():
        out[0] = fn()
    return event_ms(call, reps=reps), out[0]


def _diff(got: Tensor, ref: Tensor) -> float:
    return float((got.double() - ref.double()).abs().max())


def _occupancy(occupancy: str, lanes: int, sms: int):
    """(chains, lanes a chain, threads a block) of a P1 run at `occupancy`
    (``OCCUPANCIES``) in a mode whose chain takes `lanes` lanes."""
    if occupancy == "chains":
        return CHAINS, lanes, CHASE_THREADS
    return sms, 32, 32


def chase_entries(table: Tensor, gen: torch.Generator, sms: int,
                  runs=CHASE_RUNS, reps: int = 10) -> list:
    """P1 on `table` in each (mode, param, words) of `runs` that fits it,
    at both occupancies: each timed with CUDA events at CHAIN_STEPS and
    twice that (ms per launch), ns per dependent row the slope between the
    two (the launch and any staging fall out), its bound (the distinct
    rows' `words` float4 read once; a step's xors), and `max_abs_err` of
    both outputs against the plain version on the same chains."""
    n_rows, dev = table.shape[0], table.device
    limit = traversal8._shared_limit(dev.index)
    out = []
    for occupancy in OCCUPANCIES:
        chains = _occupancy(occupancy, 1, sms)[0]
        idx0 = _random_idx(chains, n_rows, gen, dev)
        refs, distinct = {}, {}
        for words in sorted({w for _, _, w in runs}):
            seen = torch.zeros(n_rows, dtype=torch.bool, device=dev)
            for n in (CHAIN_STEPS, 2 * CHAIN_STEPS):
                refs[n, words] = chase_rows(table, idx0, n,
                                            seen if n == CHAIN_STEPS else None, words)
            distinct[words] = int(seen.sum())
        for mode, param, words in runs:
            try:
                param, lanes = check_chase(mode, param, None, CHASE_THREADS, n_rows,
                                           limit, words)
            except ValueError:
                continue    # the table does not fit this mode
            chains, lanes, threads = _occupancy(occupancy, lanes, sms)
            ms, err = {}, 0.0
            for n in (CHAIN_STEPS, 2 * CHAIN_STEPS):
                ms[n], got = _timed(lambda: chase_rows_cuda(
                    table, idx0, n, mode, param, lanes, threads, words), reps=reps)
                err = max(err, _diff(got, refs[n, words]))
            b, by = bound_ms(distinct[words] * words * 16 + chains * 8,
                             chains * CHAIN_STEPS * (4 * words + 3))
            out.append(dict(
                rows=n_rows, mode=mode, param=param, words=words, occupancy=occupancy,
                chains=chains, lanes=lanes, threads=threads, steps=CHAIN_STEPS,
                ms=ms[CHAIN_STEPS], ms_twice_the_steps=ms[2 * CHAIN_STEPS],
                ns_per_dependent_row=(ms[2 * CHAIN_STEPS] - ms[CHAIN_STEPS])
                * 1e6 / CHAIN_STEPS,
                ns_per_dependent_fetch=ms[CHAIN_STEPS] * 1e6 / CHAIN_STEPS,
                distinct_rows=distinct[words], bound_ms=b, bound_by=by,
                max_abs_err=err))
    return out


def floor_entry(entries, design: str, rows: int, param: int = None,
                occupancy: str = "warp", words: int = NODE_WORDS):
    """The P1 entry a traversal design's chain floor takes (its steps times
    the entry's ``ns_per_dependent_row``): a node step's read (`words`
    float4) in the mode of the design's read (``DESIGN_READS``; a
    cluster's blocks `param` where that was measured, else any), at
    `occupancy` (one chain a warp: the latency alone), the lowest over the
    measured tables of at most `rows` rows (the smallest measured one
    where none is that small). A traversal keeps its hot rows in the
    nearest cache, so the table that caches best, not one of the call's
    own size, keeps the floor a lower bound. None when the mode was not
    measured."""
    mode, want = DESIGN_READS[design]
    want = param if want is None else want
    cand = [e for e in entries if e["mode"] == mode and e["occupancy"] == occupancy
            and e.get("words", ROW_WORDS) == words]
    if want is not None and any(e["param"] == want for e in cand):
        cand = [e for e in cand if e["param"] == want]
    if not cand:
        return None
    most = max(rows, min(e["rows"] for e in cand))
    return min((e for e in cand if e["rows"] <= most),
               key=lambda e: e["ns_per_dependent_row"])


def split_floor(entries, rows: int, near_far, arith_ns: float = 0.0):
    """(ms, (near entry, far entry)) of the split design's chain floor on a
    top table of `rows` rows: the most, over `near_far` ((steps on the
    rows it stages, steps on the rest) of each of a call's lanes, or of
    each distinct pair), of the staged steps at floor_entry's shared
    reading and the others at its thread reading, each step with
    `arith_ns` of arithmetic added (``step_arith_ns``); (None, None) when
    either mode was not measured."""
    near, far = floor_entry(entries, "shared", rows), floor_entry(entries, "thread", rows)
    if near is None or far is None or not len(near_far):
        return None, None
    a, b = (max(e["ns_per_dependent_row"], 0.0) + arith_ns for e in (near, far))
    return max(n * a + f * b for n, f in near_far) / 1e6, (near, far)


def _words_off(got: Tensor, ref: Tensor) -> float:
    """0.0 when two float32 or int32 tensors hold the same bits, else the
    number of 32-bit words that differ (or inf for another shape)."""
    if got.shape != ref.shape:
        return float("inf")
    a, b = got.view(torch.int32), ref.view(torch.int32)
    return 0.0 if torch.equal(a, b) else float((a != b).sum())


def synthetic_take_calls(gen: torch.Generator, dev, queries: int = 2048,
                         rows: int = 20000) -> dict:
    """P2 (a)'s two index streams on a random (rows, TAKE_WIDTH) table,
    for a check at a small size: "runs", the hash grid's form (RUNS runs
    of RUN_ROWS rows a query from starts up to the row count, clamped), and
    "random", as many random rows."""
    table = torch.rand((rows, TAKE_WIDTH), generator=gen, device=dev)
    starts = torch.randint(0, rows + 1, (queries, RUNS), generator=gen,
                           dtype=torch.int32, device=dev)
    rnd = torch.randint(0, rows, (queries * RUNS,), generator=gen, dtype=torch.int32,
                        device=dev)
    return {"runs": (table, run_index(starts, rows)), "random": (table, rnd)}


def take_entries(call: str, table: Tensor, idx: Tensor, reps: int = 10) -> list:
    """P2 (a) on one index stream (`call`): every design, each timed with CUDA events (ms per launch) and held to
    the plain version bit for bit (``_words_off``), beside
    ``torch.index_select`` on the same int32 index (library_ms; the index
    is built before any timing) and the port's own ``table[idx.long()]``
    with its int64 conversion (plain_ms). ``torch.index_select`` is also
    timed on the table's rows viewed as 8- and 16-byte words, the same
    bytes in fewer elements (index_select_ms_by_word, by word bytes): its
    time against the word count says whether it is bound by elements or
    by bytes. The bound counts the distinct table rows the indices touch,
    the index and the output, each once, at the device memory rate. The
    fastest design is marked `kept`."""
    N, W, dev = idx.shape[0], table.shape[1], table.device
    ref = gather_take(table, idx)
    port_ms = event_ms(lambda: gather_take(table, idx), reps=reps)
    by_word = {size: event_ms(lambda: torch.index_select(table.view(dt), 0, idx),
                              reps=reps)
               for size, dt in ((4, torch.float32), (8, torch.int64),
                                (16, torch.complex128))}
    library_ms = by_word[4]
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    seen[idx.long()] = True
    distinct = int(seen.sum())
    del seen
    b, by = bound_ms(distinct * W * 4 + N * 4 + N * W * 4, 0)
    out = []
    for design in TAKE_DESIGNS:
        ms, got = _timed(lambda: gather_take_cuda(table, idx, design), reps=reps)
        out.append(dict(call=call, design=design, rows=table.shape[0], width=W,
                        gathers=N, distinct_rows=distinct, ms=ms, library_ms=library_ms,
                        index_select_ms_by_word=by_word,
                        plain_ms=port_ms, bound_ms=b, bound_by=by, bound_share=b / ms,
                        gbps=N * W * 4 / (ms * 1e-3) / 1e9,
                        faster_than_index_select=ms < library_ms,
                        max_abs_err=_words_off(got, ref)))
        del got
    best = min(out, key=lambda e: e["ms"])
    for e in out:
        e["kept"] = e is best
    return out


def synthetic_step_rows(gen: torch.Generator, dev) -> Tensor:
    """(2, 128) float32: a node row of 8 random boxes in the unit cube (4
    leaf links, 3 node links, one empty child) and a leaf row of 12 random
    triangles in it (the last slot empty), for a check at a small size."""
    node = torch.zeros(128, dtype=torch.float32, device=dev)
    a, b = (torch.rand((3, 8), generator=gen, device=dev) for _ in range(2))
    node[0:24] = torch.minimum(a, b).reshape(-1)
    node[24:48] = torch.maximum(a, b).reshape(-1)
    node[48:56] = torch.tensor([-2, -3, 5, -4, 9, traversal8.DONE, 12, -5],
                               dtype=torch.int32, device=dev).view(torch.float32)
    leaf = torch.zeros(128, dtype=torch.float32, device=dev)
    v0 = torch.rand((3, 12), generator=gen, device=dev)
    e = (torch.rand((6, 12), generator=gen, device=dev) - 0.5) * 1.5
    leaf[0:108] = torch.cat([v0, e]).reshape(-1)
    ids = torch.arange(12, dtype=torch.int32, device=dev) + 40
    ids[-1] = -1
    leaf[108:120] = ids.view(torch.float32)
    return torch.stack([node, leaf])


def table_step_rows(table: Tensor) -> Tensor:
    """(2, 128): a BVH8 table's root row and the first leaf row a walk down
    its first children reaches."""
    row = 0
    for _ in range(table.shape[0]):
        links = table[row, 48:56].view(torch.int32).tolist()
        leaf = [x for x in links if x <= -2]
        if leaf:
            return torch.stack([table[0], table[-2 - leaf[0]]]).contiguous()
        row = next(x for x in links if x >= 0)
    raise ValueError("no leaf row under the root")


def step_rays(rows: Tensor, n: int, gen: torch.Generator) -> Rays:
    """n rays for step_only: origins uniform over the node row's box (its
    children's union) grown by a tenth a side, random unit directions,
    tmin 1e-4, tmax 1e30."""
    node, dev = rows[0], rows.device
    valid = node[48:56].view(torch.int32) != traversal8.DONE
    lo = node[0:24].reshape(3, 8)[:, valid].amin(1)
    hi = node[24:48].reshape(3, 8)[:, valid].amax(1)
    ext = hi - lo
    o = lo + (torch.rand((n, 3), generator=gen, device=dev) * 1.2 - 0.1) * ext
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return Rays(o.contiguous(), d.contiguous(), torch.full((n,), 1e-4, device=dev),
                torch.full((n,), 1e30, device=dev))


def step_entries(rows: Tensor, gen: torch.Generator, sms: int,
                 iters: int = STEP_ITERS, reps: int = 5) -> list:
    """P2 (b): step_only of each kind (``STEP_KINDS``) at each occupancy
    (``STEP_OCCUPANCIES``: one warp a block and a block an SM; the blocks
    of CHASE_THREADS threads the kernel's registers let every SM hold),
    timed with CUDA events at `iters` steps and twice that (ms per launch),
    each output held to the plain version bit for bit. ns_per_step is the
    slope (the launch falls out): at one warp an SM a step's latency, at
    full occupancy the card's time for a step of all its lanes, so
    ns_per_lane_step is the issue rate. The bound: the rays in and the
    outputs out once, or the steps' float32 operations."""
    out = []
    for kind, any_hit in STEP_KINDS:
        node = kind == "node"
        per_sm = step_only_blocks(node, any_hit)
        for occupancy in STEP_OCCUPANCIES:
            warp = occupancy == "warp"
            threads = 32 if warp else CHASE_THREADS
            lanes = sms * (32 if warp else per_sm * CHASE_THREADS)
            rays = step_rays(rows, lanes, gen)
            ms, err = {}, 0.0
            for n in (iters, 2 * iters):
                ms[n], got = _timed(lambda: step_only_cuda(rows, rays, n, node, any_hit,
                                                           threads), reps=reps)
                ref = step_only(rows, rays, n, node, any_hit)
                err = max(err, _words_off(got[0], ref[0]), _words_off(got[1], ref[1]))
            dt = (ms[2 * iters] - ms[iters]) * 1e6
            ops = traversal8.NODE_STEP_FLOPS if node else LEAF_STEP_FLOPS
            b, by = bound_ms(lanes * 60 + 1024, lanes * iters * ops)
            out.append(dict(kind=kind, any_hit=any_hit, occupancy=occupancy, lanes=lanes,
                            threads=threads, blocks_per_sm=1 if warp else per_sm,
                            steps=iters, ms=ms[iters], ms_twice_the_steps=ms[2 * iters],
                            ns_per_step=dt / iters, ns_per_lane_step=dt / (iters * lanes),
                            ns_per_sm_step=dt * sms / (iters * lanes),
                            bound_ms=b, bound_by=by, max_abs_err=err))
    return out


def step_arith_ns(entries, per_lane: bool = False) -> tuple:
    """(ns, entry): the smallest step_only reading at one warp an SM over
    the node and leaf steps, closest and any-hit: what a chain floor adds
    to each step's row read where one thread runs a ray's step, so that the
    floor stays a lower bound. With `per_lane`, a lane's share where a
    group of lanes splits a step's tests one child or triangle a lane (K1's
    group design): the smaller of a node step over its 8 children and a
    leaf step over its 12 triangles. (0.0, None) when none was measured."""
    cand = [e for e in entries if e["occupancy"] == "warp"]
    if not cand:
        return 0.0, None

    def ns(e):
        share = (8 if e["kind"] == "node" else 12) if per_lane else 1
        return max(e["ns_per_step"], 0.0) / share
    e = min(cand, key=ns)
    return ns(e), e


def synthetic_queue_items(n: int, gen: torch.Generator, dev, dead: float = 0.4):
    """(steps, tmin, tmax) of n items for P3's threshold form at a small
    size: 1-40 busy steps, tmin 0, tmax 1e30 or, for a `dead` share of
    them, -1."""
    steps = torch.randint(1, 41, (n,), generator=gen, dtype=torch.int32, device=dev)
    cut = torch.rand(n, generator=gen, device=dev) < dead
    return (steps, torch.zeros(n, device=dev),
            torch.where(cut, -1.0, 1e30).to(torch.float32).contiguous())


def queue_entries(dev, sizes, stream, sms: int, reps: int = 10) -> list:
    """P3 in each form (``QUEUE_FORMS``) at each occupancy: the memset and
    work-area forms on queues of each of `sizes`, the threshold form on
    `stream` (steps, tmin, tmax of its items), timed with CUDA events (ms
    per launch); every launch's counts held to all ones and the threshold
    form's out to ``queue_threshold``. ns_per_claim is a warp's time per claim
    (the launch's time over its claims a warp); the threshold form also
    reports the share of its warps' cycles spent in fetch rounds
    (clock64) and that share of the time per claim."""
    out = []
    for form in QUEUE_FORMS:
        items = stream if form == "threshold" else None
        for occupancy in QUEUE_OCCUPANCIES:
            for n in ((stream[0].shape[0],) if items is not None else sizes):
                runs = []
                ms = event_ms(lambda: runs.append(queue_fetch_cuda(n, dev, form, occupancy,
                                                                   items)), reps=reps)
                ones = torch.ones(n, dtype=torch.int32, device=dev)
                err = max(_diff(r[0], ones) for r in runs)
                if items is not None:
                    want = queue_threshold(*stream)[1]
                    err = max(err, max(_words_off(r[1], want) for r in runs))
                claims = statistics.median(int(r[2]) for r in runs)
                warps = queue_warps(form, n, occupancy, sms)
                b, by = bound_ms(n * (20 if items is not None else 4), n)
                e = dict(form=form, occupancy=occupancy, items=n, warps=warps, ms=ms,
                         claims=claims, claims_per_warp=claims / warps,
                         ns_per_claim=ms * 1e6 * warps / max(claims, 1),
                         ns_per_item=ms * 1e6 / n, launches=len(runs), bound_ms=b,
                         bound_by=by, max_abs_err=err)
                if items is not None:
                    st = torch.stack([r[3] for r in runs]).double().median(0).values
                    share = float(st[1] / st[2])
                    e.update(fetch_share=share,
                             fetch_ns_per_claim=share * e["ns_per_claim"],
                             dead=int((~(stream[1] <= stream[2])).sum()),
                             busy_steps=int(stream[0][stream[1] <= stream[2]].sum()))
                out.append(e)
    return out


def measure(device, seed: int = 1, table_rows=TABLE_ROWS, gathers: int = GATHERS,
            loop_steps: int = LOOP_STEPS, queue_items=QUEUE_ITEMS,
            chase_runs=CHASE_RUNS, take_calls: dict = None, step_rows: Tensor = None,
            step_iters: int = STEP_ITERS, queue_stream=None) -> dict:
    """P1-P3 timed with CUDA events (ms per launch), each entry with its
    bound and its `max_abs_err`: the largest difference between the output
    of the kernel's timed launches and its plain version's on the same
    inputs (0 when right; P3's plain counts are all ones). Every launch
    here is a timed one. P1 runs every run of `chase_runs` that fits each
    table at both occupancies (``chase_entries``). P2 (a) times the index
    streams of `take_calls` ({name: (table, idx)}; random ones at a small
    size when None, ``take_entries``), P2 (b) step_only on `step_rows`
    ((2, 128); random rows when None, ``step_entries``), P3 every form
    (``queue_entries``) on queues of `queue_items` items and, for the
    threshold form, `queue_stream` ((steps, tmin, tmax); a random one of
    ROW_QUEUE_ITEMS items when None). The entries of the kernel table's
    rows (ROW_TABLE_ROWS: P1 in mode thread, whole rows, at 1,024 chains;
    ROW_QUEUE_ITEMS; step_only's node step at one warp an SM) also time
    the plain version. The sizes default to the module constants; a
    smaller call checks the kernels quickly."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p1, p2 = [], []
    for n_rows in table_rows:
        table = _random_table(n_rows, gen, dev)
        p1 += chase_entries(table, gen, sms, chase_runs)
        if n_rows == ROW_TABLE_ROWS:
            idx0 = _random_idx(CHAINS, n_rows, gen, dev)
            next(e for e in p1 if e["rows"] == n_rows and e["mode"] == "thread"
                 and e["words"] == ROW_WORDS and e["occupancy"] == "chains")["plain_ms"] = event_ms(
                lambda: chase_rows(table, idx0, CHAIN_STEPS), reps=3, warmup=1)
        idx = _random_idx(gathers, n_rows, gen, dev)
        ref = gather_rows(table, idx)
        for warp in (False, True):
            ms, got = _timed(lambda: gather_rows_cuda(table, idx, warp=warp))
            b, by = bound_ms(n_rows * ROW_BYTES + gathers * 8, gathers * 128)
            p2.append(dict(rows=n_rows, layout="warp" if warp else "thread",
                           gathers=gathers, ms=ms,
                           rows_gbps=gathers * ROW_BYTES / (ms * 1e-3) / 1e9,
                           bound_ms=b, bound_by=by, max_abs_err=_diff(got, ref)))
            if n_rows == ROW_TABLE_ROWS and not warp:
                p2[-1]["plain_ms"] = event_ms(lambda: gather_rows(table, idx),
                                              reps=3, warmup=1)
        del table, ref
    x0 = torch.rand(LOOP_LANES, generator=gen, device=dev)
    ms, got = _timed(lambda: loop_only_cuda(x0, loop_steps), reps=5)
    loop = dict(lanes=LOOP_LANES, steps=loop_steps, ms=ms,
                ns_per_step=ms * 1e6 / loop_steps,
                max_abs_err=_diff(got, loop_only(x0, loop_steps)))
    take = []
    for name, (table, idx) in (take_calls or synthetic_take_calls(gen, dev)).items():
        take += take_entries(name, table, idx)
    rows = synthetic_step_rows(gen, dev) if step_rows is None else step_rows
    step = step_entries(rows, gen, sms, step_iters)
    main = next(e for e in step if e["kind"] == "node" and not e["any_hit"]
                and e["occupancy"] == "warp")
    rays = step_rays(rows, main["lanes"], gen)
    main["plain_ms"] = event_ms(lambda: step_only(rows, rays, step_iters, True),
                                reps=1, warmup=1)
    stream = queue_stream or synthetic_queue_items(ROW_QUEUE_ITEMS, gen, dev)
    p3 = queue_entries(dev, queue_items, stream, sms)
    for e in p3:
        if e["items"] == ROW_QUEUE_ITEMS and e["occupancy"] == "full":
            e["plain_ms"] = event_ms(
                (lambda: queue_threshold(*stream)) if e["form"] == "threshold"
                else (lambda: queue_fetch(ROW_QUEUE_ITEMS, 1024, dev)), reps=3, warmup=1)
    return dict(P1=p1, P2=p2, loop_only=loop, take=take, step_only=step, P3=p3)


def max_abs_err(res: dict) -> float:
    """The largest `max_abs_err` of the entries of a `measure` result."""
    return max(e["max_abs_err"]
               for e in (*res["P1"], *res["P2"], res["loop_only"], *res["take"],
                         *res["step_only"], *res["P3"]))
