"""Microbenchmarks of the traversal kernels' building blocks on the card:
P1, P2 and P3 (``csrc/microbench.cu``).

They replace the JAX package's TPU microbenchmarks and Mosaic probes
(``tools/microbench_r2.py``, ``tools/microbench_r2c.py``,
``tools/probe_mosaic_pool.py``) and ask the questions that bound the
traversal kernels K1-K4 on Hopper:

- P1 ``chase_rows``: the latency of a dependent 512-byte row fetch, from
  device memory through L1/L2 and from shared memory;
- P2 ``gather_rows``: the throughput of independent row gathers in K1's
  thread-per-row layout and a coalesced warp-per-row layout; and
  ``loop_only``, the cost of a loop step by itself;
- P3 ``queue_fetch``: the cost of K4's warp queue fetch per item, and that
  it hands out every item exactly once.

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

import torch

from ..ops import cuda_build

Tensor = torch.Tensor

ROW_BYTES = 512
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
PEAK_FLOPS_F32 = 67e12        # H100 SXM float32 outside the tensor cores
SHARED_MAX_ROWS = 232448 // ROW_BYTES   # 227 KB a block may use: 454 rows
# the TPU microbenchmarks' table sizes, then Cornell's, veach-mis's and the
# 1.2M-triangle San Miguel stand-in's (108 MB, past the 50 MB L2)
TABLE_ROWS = (256, 1024, 4096, 317, 331, 211592)
CHAINS, CHAIN_STEPS = 1024, 256        # P1's B and steps
GATHERS = 1 << 20                      # P2's independent gathers per launch
LOOP_LANES, LOOP_STEPS = 1024, 65536
QUEUE_ITEMS = (65536, 131072, 262144)  # the path's merged wavefront sizes
LOOP_FACTOR = 1.000001
CHAIN_MIX = 0x9E3779B9
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
    """(N, 128) float32 rows -> (N,) int64 xor of each row's 32-bit words,
    as an unsigned value."""
    w = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    while w.shape[1] > 1:
        half = w.shape[1] // 2
        w = w[:, :half] ^ w[:, half:]
    return w[:, 0]


def _as_int32(u: Tensor) -> Tensor:
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def chase_rows(table: Tensor, idx0: Tensor, n_steps: int) -> Tensor:
    """P1's plain version: (C,) int32 last row of each chain."""
    n_rows = table.shape[0]
    idx = idx0.to(torch.int64)
    for s in range(n_steps):
        idx = ((_row_xor(table[idx]) + s * CHAIN_MIX) & 0xFFFFFFFF) % n_rows
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


# --------------------------------------------------------------- kernel wrappers

def _lib():
    lib = cuda_build.load_library("microbench.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ctl_chase_rows.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp]
    lib.ctl_gather_rows.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.ctl_loop_only.argtypes = [vp, ci, ci, vp, vp]
    lib.ctl_queue_fetch.argtypes = [ci, vp, vp, vp]
    for fn in (lib.ctl_chase_rows, lib.ctl_gather_rows, lib.ctl_loop_only,
               lib.ctl_queue_fetch):
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


def chase_rows_cuda(table: Tensor, idx0: Tensor, n_steps: int,
                    shared: bool = False) -> Tensor:
    """P1 on the card; `shared` stages the table in shared memory (at most
    SHARED_MAX_ROWS rows)."""
    _check_table(table)
    _check(idx0, "idx0", torch.int32, (idx0.shape[0],))
    if shared and table.shape[0] > SHARED_MAX_ROWS:
        raise ValueError(f"{table.shape[0]} rows do not fit shared memory")
    out = torch.empty_like(idx0)
    _raise_on(_lib().ctl_chase_rows(_p(table), table.shape[0], _p(idx0),
                                    idx0.shape[0], n_steps, int(shared),
                                    _p(out), _stream(table.device)),
              "chase_rows")
    chase_rows_cuda.launches += 1
    return out


chase_rows_cuda.launches = 0


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


def queue_fetch_cuda(n: int, device="cuda") -> Tensor:
    """P3 on the card: (n,) int32 counts, each 1 when the queue is right."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("queue_fetch_cuda runs on a CUDA device")
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    counter = torch.empty(1, dtype=torch.int32, device=device)
    _raise_on(_lib().ctl_queue_fetch(n, _p(counter), _p(counts),
                                     _stream(device)), "queue_fetch")
    queue_fetch_cuda.launches += 1
    return counts


queue_fetch_cuda.launches = 0
KERNELS = (chase_rows_cuda, gather_rows_cuda, loop_only_cuda, queue_fetch_cuda)


# --------------------------------------------------------------- on the card

def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of `fn` on the current stream: CUDA events
    around `reps` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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


def measure(device, seed: int = 1, table_rows=TABLE_ROWS, gathers: int = GATHERS,
            loop_steps: int = LOOP_STEPS, queue_items=QUEUE_ITEMS) -> dict:
    """P1-P3 timed with CUDA events (ms per launch), each entry with its
    bound and its `max_abs_err`: the largest difference between the output
    of the kernel's timed launches and its plain version's on the same
    inputs (0 when right; P3's plain counts are all ones). Every launch
    here is a timed one. The entries of the kernel table's rows
    (ROW_TABLE_ROWS, ROW_QUEUE_ITEMS) also time the plain version. The
    sizes default to the module constants; a smaller call checks the
    kernels quickly."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p1, p2 = [], []
    for n_rows in table_rows:
        table = _random_table(n_rows, gen, dev)
        idx0 = _random_idx(CHAINS, n_rows, gen, dev)
        ref = chase_rows(table, idx0, CHAIN_STEPS)
        for shared in (False, True):
            if shared and n_rows > SHARED_MAX_ROWS:
                continue
            ms, got = _timed(lambda: chase_rows_cuda(table, idx0, CHAIN_STEPS,
                                                     shared=shared))
            b, by = bound_ms(n_rows * ROW_BYTES + CHAINS * 8,
                             CHAINS * CHAIN_STEPS * 131)
            p1.append(dict(rows=n_rows, memory="shared" if shared else "global",
                           chains=CHAINS, steps=CHAIN_STEPS, ms=ms,
                           ns_per_dependent_fetch=ms * 1e6 / CHAIN_STEPS,
                           bound_ms=b, bound_by=by, max_abs_err=_diff(got, ref)))
            if n_rows == ROW_TABLE_ROWS and not shared:
                p1[-1]["plain_ms"] = event_ms(
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
    p3 = []
    for n in queue_items:
        runs = []
        ms = event_ms(lambda: runs.append(queue_fetch_cuda(n, dev)))
        ref = queue_fetch(n, 1024, dev)
        b, by = bound_ms(n * 4, n)
        p3.append(dict(items=n, ms=ms, ns_per_item=ms * 1e6 / n, launches=len(runs),
                       bound_ms=b, bound_by=by,
                       max_abs_err=max(_diff(c, ref) for c in runs)))
        if n == ROW_QUEUE_ITEMS:
            p3[-1]["plain_ms"] = event_ms(lambda: queue_fetch(n, 1024, dev),
                                          reps=3, warmup=1)
    return dict(P1=p1, P2=p2, loop_only=loop, P3=p3)


def max_abs_err(res: dict) -> float:
    """The largest `max_abs_err` of the entries of a `measure` result."""
    return max(e["max_abs_err"]
               for e in (*res["P1"], *res["P2"], res["loop_only"], *res["P3"]))
